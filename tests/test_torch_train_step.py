"""The port's train step (msml_torch.train.train_step) against JAX's own
`make_train_step` on a one-device CPU mesh.

arc18_msml's structure at full width and depth (iResNet-18 FRB, U-Net OSB,
four FMCnn [3, 2, sigmoid, mul], AMArcFace s = 64, m = 0.48, device_light)
in float32 with 64 classes, batch 4 at 112 x 112. Both sides start from the
same weights (numpy draws in the flax layout by
`test_torch_nn.random_variables`, carried by `msml_torch.tools.convert`),
take the same synthetic uint8 batches, and the port is given JAX's relight
draws, recomputed here from JAX's key chain.

Tolerances, for float32 sums taken in another order: metrics rtol 1e-4.
The parameter updates (lr times the momentum buffer): relative L2 error
<= 5e-3 over all tensors together and <= 5e-2 for each tensor. Many
gradients here are mostly cancellation (a BatchNorm bias ahead of a conv
and another BatchNorm; the FM blocks behind a sigmoid gate), and float32
knows them to a few 1e-3 on either side: measured 1.9e-4 to 1.2e-3 over
all tensors and up to 1.5e-2 for one tensor, the larger figures when JAX
loads its step from the persistent compile cache. The parameters after the
step: atol 1e-6 (an update can be below the weight's float32 spacing, so
p_after - p_before is not the update). BN running statistics: atol 1e-5,
rtol 1e-4 (flax takes the variance as E[x^2] - E[x]^2; measured up to
1.7e-5 relative). Batch 4, not 2: with two samples the
`features` BatchNorm1d normalizes each channel to about +-1 and its
backward, (g1 - g2) (1 - xhat^2) / 2, cancels to a few digits in float32
(the grad norm of the second step then differs by 0.4 % between two
correct float32 runs).
"""

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
from msml_tpu.nn.msml import msml_from_config as jax_msml
from msml_tpu.train import optim as joptim
from msml_tpu.train.train_step import TrainState
from msml_tpu.train.train_step import make_train_step as jax_train_step
from msml_torch.core.config import Config, config_init, lr_step_factor
from msml_torch.core.precision import FULL_PRECISION
from msml_torch.nn.msml import msml_from_config
from msml_torch.tools import convert
from msml_torch.train.train_step import init_train_state, make_train_step
from test_torch_nn import random_variables

B, STEPS, SEED = 4, 2, 0
METRICS = ("total_loss", "cls_loss", "seg_loss", "kd", "nll", "grad_norm")
CFG = {
    "dataset": "synthetic", "fp16": False, "batch_size": B,
    "frb_type": "iresnet18", "osb_type": "unet", "use_osb": True,
    "fm_layers": [1, 1, 1, 1], "fm_params": [3, 2, "sigmoid", "mul"],
    "peer_params": {"use_ori": False, "use_conv": False,
                    "mask_trans": "conv", "use_decoder": False},
    "header_type": "AMArcFace", "header_params": [64.0, 0.48, 0.0, 0.0],
    "device_light": True, "num_classes": 64, "exp_id": 0,
    "output_prefix": "test",
}


def jax_light_draws(rng, step, b):
    """The relight uniforms of JAX's step `step` on device 0:
    fold_in(fold_in(fold_in(rng, step), 0), 0xD11) -> split 3 -> uniform
    (train_step.py:234,247; augment.py:51-54)."""
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.fold_in(rng, step), 0), 0xD11)
    return np.stack([np.asarray(jax.random.uniform(k, (b,)))
                     for k in jax.random.split(key, 3)], 1)


def batches():
    out = []
    for i in range(STEPS):
        b = synthetic_batch(B, num_classes=64, seed=i, uint8=True)
        del b["ori"]
        out.append(b)
    return out


def state_dict_of(params, batch_stats):
    return {k: v.numpy() for k, v in convert.state_dict_from_jax(
        jax.device_get(params), jax.device_get(batch_stats)).items()}


def jax_updates(momentum, lr_scales, lr, batch_stats):
    """lr * momentum of every JAX parameter, under the port's names."""
    update = jax.tree.map(lambda m, s: np.asarray(m) * (s * lr),
                          jax.device_get(momentum), lr_scales)
    return state_dict_of(update, batch_stats)


@pytest.fixture(scope="module")
def runs():
    """Both sides' metrics and state dicts before and after each step."""
    jcfg = jconfig_init(JConfig.from_dict(CFG), make_output_dir=False)
    tcfg = config_init(Config.from_dict(CFG), make_output_dir=False)
    lr = lr_step_factor(tcfg, 0)
    data = batches()

    jmodel = jax_msml(jcfg, policy=JAX_F32)
    v = random_variables(jmodel, np.zeros((B, 112, 112, 3), np.float32),
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
        draws = torch.from_numpy(jax_light_draws(rng, i, B))
        m = step(state, b, lr, light_draws=draws)
        updates = {names[p]: (state.optimizer.state[p]["momentum_buffer"]
                              * g["lr"]).numpy()
                   for g in state.optimizer.param_groups
                   for p in g["params"]}
        port_out.append(({k: float(m[k]) for k in METRICS},
                         {k: t.numpy().copy()
                          for k, t in model.state_dict().items()},
                         updates))
    return init_sd, jax_out, port_out


@pytest.mark.parametrize("n", [1, 2])
def test_metrics_match_jax(runs, n):
    _, jax_out, port_out = runs
    want, got = jax_out[n - 1][0], port_out[n - 1][0]
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0,
                                   err_msg=k)
    assert want["grad_norm"] > 5.0  # the clip is engaged


@pytest.mark.parametrize("n", [1, 2])
def test_parameter_updates_match_jax(runs, n):
    _, jax_out, port_out = runs
    got, want = port_out[n - 1][2], jax_out[n - 1][2]
    assert len(got) > 300
    sq_err = sq_want = 0.0
    for k in sorted(got):
        err = np.linalg.norm(got[k] - want[k])
        assert err <= 5e-2 * np.linalg.norm(want[k]), (k, err)
        sq_err += err ** 2
        sq_want += np.linalg.norm(want[k]) ** 2
        np.testing.assert_allclose(port_out[n - 1][1][k], jax_out[n - 1][1][k],
                                   atol=1e-6, rtol=0, err_msg=k)
    assert sq_err <= 25e-6 * sq_want, (sq_err / sq_want) ** 0.5


@pytest.mark.parametrize("n", [1, 2])
def test_bn_running_stats_match_jax(runs, n):
    init_sd, jax_out, port_out = runs
    keys = [k for k in init_sd if k.endswith((".running_mean",
                                              ".running_var"))]
    assert len(keys) > 100
    for k in keys:
        np.testing.assert_allclose(port_out[n - 1][1][k],
                                   jax_out[n - 1][1][k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)
        assert not np.array_equal(port_out[n - 1][1][k], init_sd[k]), k
