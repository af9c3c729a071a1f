"""The port's train step on the peer-KD recipe
(configs/arc18_msml_peer_dec.yaml) against JAX's own `make_train_step` on
a one-device CPU mesh: the host-float input path that the yaml runs (no
`device_light`: float NHWC `img` and `ori`, normalized on the host; the
decoder's loss off, so its parameters get only weight decay and momentum,
as in JAX). tests/test_torch_peer_step_light.py
runs the `device_light` path with the recover loss on
(`decoder_loss_weight` > 0), with the machinery here.

The recipe's structure (iResNet-18 FRB cut to one block per stage with the
frozen iResNet teacher, U-Net OSB, four FMCnn [3, 2, sigmoid, mul] with
`conv_m` and the `conv1` / `conv2` towers, the recover decoder, AMArcFace
s = 64, m = 0.48) in float32 with 16 classes, batch 4 at 112 x 112, two
steps. Both sides start from the same numpy-drawn weights
(`test_torch_nn.random_variables`, carried by `msml_torch.tools.convert`)
and take the same synthetic batches; on the `device_light` path the port
is given JAX's relight draws.

Tolerances, as tests/test_torch_train_step.py sets them and for the same
reasons: metrics rtol 1e-4; the updates (lr times the momentum buffer)
relative L2 error <= 5e-3 over all tensors and <= 5e-2 for each; the
parameters after each step atol 1e-6; BN running statistics atol 1e-5,
rtol 1e-4. The teacher's parameters and statistics stay bit for bit what
they were, on both sides, and the port's optimizer holds none of them.
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
from msml_tpu.nn import iresnet as jiresnet
from msml_tpu.nn.msml import msml_from_config as jax_msml
from msml_tpu.train import optim as joptim
from msml_tpu.train.train_step import TrainState
from msml_tpu.train.train_step import make_train_step as jax_train_step
from msml_torch.core.config import Config, config_init, lr_step_factor
from msml_torch.core.precision import FULL_PRECISION
from msml_torch.nn import iresnet
from msml_torch.nn.msml import msml_from_config
from msml_torch.train.train_step import init_train_state, make_train_step
from test_torch_nn import random_variables
from test_torch_peer_msml import WithoutLosses
from test_torch_train_step import (jax_light_draws, jax_updates,
                                   state_dict_of)

B, STEPS, SEED = 4, 2, 0
METRICS = ("total_loss", "cls_loss", "seg_loss", "kd", "nll", "grad_norm")
RECIPE = {  # configs/arc18_msml_peer_dec.yaml at 16 classes, float32
    "dataset": "synthetic", "fp16": False, "batch_size": B,
    "frb_type": "iresnet18", "osb_type": "unet", "use_osb": True,
    "fm_layers": [1, 1, 1, 1], "fm_params": [3, 2, "sigmoid", "mul"],
    "peer_params": {"use_ori": True, "use_conv": True,
                    "mask_trans": "conv", "use_decoder": True},
    "header_type": "AMArcFace", "header_params": [64.0, 0.48, 0.0, 0.0],
    "num_classes": 16, "exp_id": 0, "output_prefix": "test",
}
PEER = "frb.peer."


def batches(uint8: bool):
    return [synthetic_batch(B, num_classes=16, seed=i, uint8=uint8)
            for i in range(STEPS)]


def run_both(**over):
    """Two steps of the recipe (with `over`) on both sides; -> (initial
    state dict, JAX's [(metrics, state dict, updates)] per step, the
    port's, the port's final train state)."""
    cfg = dict(RECIPE, **over)
    jcfg = jconfig_init(JConfig.from_dict(cfg), make_output_dir=False)
    tcfg = config_init(Config.from_dict(cfg), make_output_dir=False)
    lr = lr_step_factor(tcfg, 0)
    light = bool(cfg.get("device_light"))
    data = batches(uint8=light)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jiresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        mp.setitem(iresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        jmodel = jax_msml(jcfg, policy=JAX_F32)
        x = np.zeros((B, 112, 112, 3), np.float32)
        v = random_variables(WithoutLosses(jmodel), x,
                             np.zeros((B,), np.int32), x, train=True)
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
        draws = (torch.from_numpy(jax_light_draws(rng, i, B)) if light
                 else None)
        m = step(state, b, lr, light_draws=draws)
        updates = {names[p]: (state.optimizer.state[p]["momentum_buffer"]
                              * g["lr"]).numpy()
                   for g in state.optimizer.param_groups
                   for p in g["params"]}
        port_out.append(({k: float(m[k]) for k in METRICS},
                         {k: t.numpy().copy()
                          for k, t in model.state_dict().items()},
                         updates))
    return init_sd, jax_out, port_out, state


def check_metrics(runs, n):
    _, jax_out, port_out, _ = runs
    want, got = jax_out[n - 1][0], port_out[n - 1][0]
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0,
                                   err_msg=k)
    assert want["kd"] > 0  # the teacher feeds the FMs


def check_updates(runs, n):
    _, jax_out, port_out, _ = runs
    got, want = port_out[n - 1][2], jax_out[n - 1][2]
    assert set(got) <= set(want)
    assert not any(k.startswith(PEER) for k in got)
    assert any(".conv2." in k for k in got)  # the KD tower trains
    assert any(k.startswith("frb.decoder.") for k in got)
    sq_err = sq_want = 0.0
    for k in sorted(got):
        err = np.linalg.norm(got[k] - want[k])
        assert err <= 5e-2 * np.linalg.norm(want[k]), (k, err)
        sq_err += err ** 2
        sq_want += np.linalg.norm(want[k]) ** 2
    for k in got:
        np.testing.assert_allclose(port_out[n - 1][1][k],
                                   jax_out[n - 1][1][k], atol=1e-6, rtol=0,
                                   err_msg=k)
    assert sq_err <= 25e-6 * sq_want, (sq_err / sq_want) ** 0.5


def check_bn_stats(runs, n):
    init_sd, jax_out, port_out, _ = runs
    keys = [k for k in init_sd if k.endswith((".running_mean",
                                              ".running_var"))
            and not k.startswith(PEER)]
    assert len(keys) > 100
    for k in keys:
        np.testing.assert_allclose(port_out[n - 1][1][k],
                                   jax_out[n - 1][1][k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)
        assert not np.array_equal(port_out[n - 1][1][k], init_sd[k]), k


def check_teacher_frozen(runs):
    """The teacher's tensors are bit-equal to the initial ones after every
    step on both sides; the port's optimizer has no state for them and
    none of them wants a gradient."""
    init_sd, jax_out, port_out, state = runs
    keys = [k for k in init_sd if k.startswith(PEER)]
    assert len(keys) > 50
    for out in jax_out + port_out:
        for k in keys:
            np.testing.assert_array_equal(out[1][k], init_sd[k], err_msg=k)
    teacher = state.model.frb.peer
    assert not teacher.training
    in_opt = {id(p) for g in state.optimizer.param_groups
              for p in g["params"]} | {id(p) for p in state.optimizer.state}
    for p in teacher.parameters():
        assert not p.requires_grad and p.grad is None
        assert id(p) not in in_opt


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: in the parallel test run each worker process
    shares the cores with five others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    return run_both()


@pytest.mark.parametrize("n", [1, 2])
def test_metrics_match_jax(runs, n):
    check_metrics(runs, n)


@pytest.mark.parametrize("n", [1, 2])
def test_parameter_updates_match_jax(runs, n):
    check_updates(runs, n)


@pytest.mark.parametrize("n", [1, 2])
def test_bn_running_stats_match_jax(runs, n):
    check_bn_stats(runs, n)


def test_teacher_stays_frozen(runs):
    check_teacher_frozen(runs)


def test_host_float_path_runs_no_input_stage(runs, monkeypatch):
    """Without device_light the step moves the float batch to NCHW and
    runs no input stage: not even the augment kernel's plain version."""
    from msml_torch.kernels import augment

    _, _, _, state = runs
    calls = []
    monkeypatch.setattr(augment, "augment_batch_reference",
                        lambda *a, **k: calls.append(1))
    tcfg = config_init(Config.from_dict(RECIPE), make_output_dir=False)
    m = make_train_step(tcfg)(state, batches(False)[0], 1.0)
    assert calls == [] and np.isfinite(m["total_loss"].item())
