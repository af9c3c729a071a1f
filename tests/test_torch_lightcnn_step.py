"""The port's train step on the LightCNN-29v2 gray recipe
(configs/lightcnn_msml.yaml) against JAX's own `make_train_step` on a
one-device CPU mesh, with `device_light: true` as the card runs it: the
gray uint8 batch (B, 128, 128, 1) goes through the input stage in the step
(/255, Gaussian relight with JAX's draws, no normalization: `use_norm` is
off for LightCNN), then LightCNN with the U-Net OSB on the 1-channel input,
the four FMCnn [3, 2, tanh, add], the Softmax head, the consensus loss, the
clip and SGD with the recipe's pretrained LR groups (FMs at 0.1, the head
at 10 x).

The recipe at full width and one resblock per LightCNN stage (for the
JAX compile), float32, 16 classes, batch 4, two steps, the same
numpy-drawn weights and batches on both sides. Tolerances: metrics rtol
1e-3; the updates (lr times the momentum buffer) relative L2 error <= 5e-2
for each tensor and <= 5e-3 over all together (tests/test_torch_train_
step.py's, whose docstring says why float32 knows some gradients only to
a few 1e-3); the parameters after each step atol 1e-6; BN running
statistics atol 1e-5, rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msml_tpu.core.config import Config as JConfig
from msml_tpu.core.config import config_init as jconfig_init
from msml_tpu.core.mesh import make_mesh, replicated
from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.data.synthetic import synthetic_batch
from msml_tpu.nn import lightcnn as jlightcnn
from msml_tpu.nn import msml as jmsml
from msml_tpu.train import optim as joptim
from msml_tpu.train.train_step import TrainState
from msml_tpu.train.train_step import make_train_step as jax_train_step
from msml_torch.core.config import Config, config_init, lr_step_factor
from msml_torch.core.precision import FULL_PRECISION
from msml_torch.nn import lightcnn
from msml_torch.nn.msml import msml_from_config
from msml_torch.train.train_step import init_train_state, make_train_step
from test_torch_nn import random_variables
from test_torch_train_step import (jax_light_draws, jax_updates,
                                   state_dict_of)

B, STEPS, SEED, CLASSES = 4, 2, 0, 16
METRICS = ("total_loss", "cls_loss", "seg_loss", "kd", "nll", "grad_norm")
RECIPE = {  # configs/lightcnn_msml.yaml at 16 classes, float32, device_light
    "dataset": "synthetic", "fp16": False, "batch_size": B,
    "frb_type": "lightcnn", "osb_type": "unet", "use_osb": True,
    "fm_layers": [1, 1, 1, 1], "fm_params": [3, 2, "tanh", "add"],
    "peer_params": {"use_ori": False, "use_conv": False,
                    "mask_trans": "conv", "use_decoder": False},
    "header_type": "Softmax", "header_params": [64.0, 0.5, 0.0, 0.0],
    "device_light": True, "num_classes": CLASSES, "exp_id": 0,
    "output_prefix": "test",
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: in the parallel test run each worker process
    shares the cores with five others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def batches():
    out = []
    for i in range(STEPS):
        b = synthetic_batch(B, size=128, channels=1, num_classes=CLASSES,
                            seed=i, uint8=True)
        del b["ori"]
        out.append(b)
    return out


@pytest.fixture(scope="module")
def runs():
    """-> (initial state dict, JAX's [(metrics, state dict, updates)] per
    step, the port's, the port's config)."""
    jcfg = jconfig_init(JConfig.from_dict(RECIPE), make_output_dir=False)
    tcfg = config_init(Config.from_dict(RECIPE), make_output_dir=False)
    assert tcfg.pretrained and not tcfg.use_norm and tcfg.is_gray
    lr = lr_step_factor(tcfg, 0)
    data = batches()
    layers = (1, 1, 1, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmsml, "LightCNN29v2", functools.partial(
            jlightcnn.LightCNN29v2, layers=layers))
        mp.setattr(lightcnn, "LIGHTCNN29_LAYERS", layers)
        jmodel = jmsml.msml_from_config(jcfg, policy=JAX_F32)
        v = random_variables(jmodel, np.zeros((B, 128, 128, 1), np.float32),
                             np.zeros((B,), np.int32), None, train=True)
        init_sd = state_dict_of(v["params"], v["batch_stats"])
        mesh = make_mesh(jax.devices()[:1])
        params = jax.device_put(v["params"], replicated(mesh))
        jstate = TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.device_put(v["batch_stats"], replicated(mesh)),
            momentum=jax.tree.map(jnp.zeros_like, params))
        lr_scales = joptim.build_lr_scales(v["params"], jcfg, 1)
        jstep = jax_train_step(jmodel, jcfg, mesh, lr_scales)
        rng = jax.random.PRNGKey(SEED)
        jax_out = []
        for b in data:
            jstate, m = jstep(jstate, b, lr, rng)
            jax_out.append(({k: float(m[k]) for k in METRICS},
                            state_dict_of(jstate.params, jstate.batch_stats),
                            jax_updates(jstate.momentum, lr_scales, lr,
                                        jstate.batch_stats)))
        model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu",
                                 head=True)
    model.load_state_dict({k: torch.from_numpy(a)
                           for k, a in init_sd.items()}, strict=True)
    state = init_train_state(model, tcfg, device="cpu", seed=SEED)
    step = make_train_step(tcfg)
    names = {p: n for n, p in model.named_parameters()}
    port_out = []
    for i, b in enumerate(data):
        m = step(state, b, lr,
                 light_draws=torch.from_numpy(jax_light_draws(rng, i, B)))
        updates = {names[p]: (state.optimizer.state[p]["momentum_buffer"]
                              * g["lr"]).numpy()
                   for g in state.optimizer.param_groups
                   for p in g["params"]}
        port_out.append(({k: float(m[k]) for k in METRICS},
                         {k: t.numpy().copy()
                          for k, t in model.state_dict().items()},
                         updates))
    return init_sd, jax_out, port_out, tcfg


@pytest.mark.parametrize("n", [1, 2])
def test_metrics_match_jax(runs, n):
    _, jax_out, port_out, _ = runs
    want, got = jax_out[n - 1][0], port_out[n - 1][0]
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=0,
                                   err_msg=k)
    assert want["kd"] == 0.0 and np.isfinite(want["total_loss"])


@pytest.mark.parametrize("n", [1, 2])
def test_parameter_updates_match_jax(runs, n):
    _, jax_out, port_out, _ = runs
    got, want = port_out[n - 1][2], jax_out[n - 1][2]
    assert set(got) <= set(want)
    assert len(got) == sum(1 for k in want if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")))
    sq_err = sq_want = 0.0
    for k in sorted(got):
        err = np.linalg.norm(got[k] - want[k])
        assert err <= 5e-2 * np.linalg.norm(want[k]), (k, err)
        sq_err += err ** 2
        sq_want += np.linalg.norm(want[k]) ** 2
        np.testing.assert_allclose(port_out[n - 1][1][k],
                                   jax_out[n - 1][1][k], atol=1e-6, rtol=0,
                                   err_msg=k)
    assert sq_err <= 25e-6 * sq_want, (sq_err / sq_want) ** 0.5


@pytest.mark.parametrize("n", [1, 2])
def test_bn_running_stats_match_jax(runs, n):
    """The OSB's and the FMs' BatchNorms (LightCNN has none)."""
    init_sd, jax_out, port_out, _ = runs
    keys = [k for k in init_sd if k.endswith((".running_mean",
                                              ".running_var"))]
    assert keys and not any(k.startswith("frb.") and ".fm_ops." not in k
                            for k in keys)
    for k in keys:
        np.testing.assert_allclose(port_out[n - 1][1][k],
                                   jax_out[n - 1][1][k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_pretrained_lr_groups(runs):
    """The recipe's derived `pretrained`: three learning rates besides the
    OSB's, the head's ten times the base."""
    _, _, _, tcfg = runs
    base = tcfg.lr / 512.0 * B
    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu",
                             head=True)
    lrs = sorted({g["lr"] for g in init_train_state(
        model, tcfg, "cpu").optimizer.param_groups})
    assert np.allclose(lrs, sorted({0.01 / 512 * B, 0.1 / 512 * B, base,
                                    10 * base}))
