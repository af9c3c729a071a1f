"""The port's modules (msml_torch.nn) against their flax counterparts.

Both sides run in float32 on the CPU with the same weights: random numpy
arrays (seeded) in the flax tree layout, carried into the port by
`msml_torch.tools.convert`. Activations go in as NHWC on the JAX side and
NCHW on the port's side.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.nn import common as jcommon
from msml_tpu.nn import fm as jfm
from msml_tpu.nn import iresnet as jiresnet
from msml_tpu.nn import unet as junet
from msml_torch.core.precision import FULL_PRECISION
from msml_torch.nn import common, fm, iresnet, unet
from msml_torch.tools import convert

ATOL = 1e-5  # float32 conv sums in another order than XLA's
ARC18_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "arc18_msml.yaml")


def random_variables(module, *args, seed=0, **kwargs):
    """Flax variables for `module` with every leaf drawn from numpy: kernels
    lecun-normal, head weights U(-0.1, 0.1), biases N(0, 0.05), BN scale
    U(0.5, 1.5), PReLU slope U(0.1, 0.4), running mean N(0, 0.1) and
    variance U(0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **kwargs))
    rs = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rs.randn(*s.shape) / np.sqrt(fan_in)
        elif name == "weight":
            v = rs.uniform(-0.1, 0.1, s.shape)
        elif name in ("bias", "mean"):
            v = rs.randn(*s.shape) * (0.05 if name == "bias" else 0.1)
        elif name in ("scale", "var"):
            v = rs.uniform(0.5, 1.5, s.shape)
        elif name == "alpha":
            v = rs.uniform(0.1, 0.4, s.shape)
        else:
            raise KeyError(name)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def emitted(fn, variables, *args):
    """Run one of convert's tree walkers on `variables`; -> state dict with
    the leading 'm.' stripped."""
    e = convert._Emitter(variables["params"],
                         variables.get("batch_stats", {}))
    fn(e, *args)
    return {k[2:]: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in e.out.items()}


def input_nhwc(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_prelu():
    x = input_nhwc((2, 5, 5, 6))
    v = random_variables(jcommon.PReLU(), x)
    want = jcommon.PReLU().apply(v, x)
    m = common.PReLU(6)
    m.load_state_dict({"weight": torch.from_numpy(v["params"]["alpha"])})
    np.testing.assert_allclose(to_nhwc(m(nchw(x))), want, atol=ATOL, rtol=0)


def test_batch_norm_eval():
    x = input_nhwc((2, 5, 5, 6))
    mod = jcommon.batch_norm(False)
    v = random_variables(mod, x)
    want = mod.apply(v, x)
    m = common.batch_norm(6).eval()
    m.load_state_dict(emitted(lambda e: e.bn("m", ()), v))
    np.testing.assert_allclose(to_nhwc(m(nchw(x))), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [3, 4])
def test_conv_transpose(k):
    x = input_nhwc((2, 7, 7, 8))
    mod = jcommon.ConvTranspose2d(18, k, 2, 1)
    v = random_variables(mod, x)
    want = np.asarray(mod.apply(v, x))
    m = common.conv_transpose(8, 18, k)
    m.load_state_dict(emitted(lambda e: e.conv("m", ()), v))
    got = to_nhwc(m(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_dap():
    x = input_nhwc((2, 6, 6, 18))
    want = jcommon.dap(jnp.asarray(x), 2, 3)
    got = to_nhwc(common.dap(nchw(x), 2, 3))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("inplanes,planes,blocks", [(8, 8, 1), (8, 16, 2)])
def test_res_stage(inplanes, planes, blocks):
    """IBasicBlock with and without downsample, chained as a ResStage."""
    x = input_nhwc((2, 8, 8, inplanes))
    mod = jiresnet.ResStage(planes, blocks, 2)
    v = random_variables(mod, x, False)
    want = mod.apply(v, x, False)
    m = iresnet.ResStage(inplanes, planes, blocks, 2).eval()
    m.load_state_dict(emitted(lambda e: convert._stage(e, "m", ()), v))
    np.testing.assert_allclose(to_nhwc(m(nchw(x))), want, atol=ATOL, rtol=0)


def test_global_conv_module():
    x = input_nhwc((2, 9, 9, 8))
    mod = junet.GlobalConvModule(6, 7)
    v = random_variables(mod, x)
    want = mod.apply(v, x)
    m = unet.GlobalConvModule(8, 6, 7)
    m.load_state_dict(emitted(lambda e: [
        e.conv(f"m.conv_{leg}", (f"conv_{leg}",), bias=True)
        for leg in ("l1", "l2", "r1", "r2")], v))
    np.testing.assert_allclose(to_nhwc(m(nchw(x))), want, atol=ATOL, rtol=0)


def test_resblock_bottle():
    x = input_nhwc((2, 6, 6, 16))
    mod = jfm.ResblockBottle(16)
    v = random_variables(mod, x, False)
    want = mod.apply(v, x, False)
    m = fm.ResblockBottle(16).eval()

    def walk(e):
        for ci in (1, 2, 3):
            e.conv(f"m.conv{ci}", (f"conv{ci}",))
            e.bn(f"m.bn{ci}", (f"bn{ci}",))
            e.prelu(f"m.prelu{ci}", (f"prelu{ci}",))

    m.load_state_dict(emitted(walk, v))
    np.testing.assert_allclose(to_nhwc(m(nchw(x))), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("act,arith", [("sigmoid", "mul"), ("tanh", "add")])
def test_fmcnn(act, arith):
    yf = input_nhwc((2, 7, 7, 16))
    yo = input_nhwc((2, 7, 7, 18), seed=2)
    mod = jfm.FMCnn(16, 3, 2, act, arith, policy=JAX_F32)
    v = random_variables(mod, yf, yo, None, False)
    want, kd = mod.apply(v, yf, yo, None, False)
    assert kd is None
    m = fm.FMCnn(16, kernel_size=3, resblocks=2, activation=act,
                 arith_strategy=arith).eval()
    m.load_state_dict(emitted(lambda e: convert._fm(e, "m", ()), v))
    np.testing.assert_allclose(to_nhwc(m(nchw(yf), nchw(yo))), want,
                               atol=ATOL, rtol=0)


def arc18_configs():
    """The flagship config derived by both packages."""
    from msml_tpu.core.config import config_init as jax_init
    from msml_tpu.core.config import load_yaml as jax_yaml
    from msml_torch.core.config import config_init, load_yaml

    jcfg = jax_init(jax_yaml(ARC18_YAML), make_output_dir=False)
    tcfg = config_init(load_yaml(ARC18_YAML), make_output_dir=False)
    return jcfg, tcfg


@pytest.fixture
def shallow_iresnet18(monkeypatch):
    """iresnet18 cut to one block per stage in both packages."""
    from msml_torch.nn import iresnet as tiresnet
    monkeypatch.setitem(jiresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
    monkeypatch.setitem(tiresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))


def test_msml_eval_forward(shallow_iresnet18):
    """The whole eval forward (feature, final_seg), arc18_msml at full width
    and FRB depth 1 per stage, B = 2 at 112 x 112, converted weights."""
    from msml_tpu.nn.msml import msml_from_config as jax_msml
    from msml_torch.nn.msml import msml_from_config

    jcfg, tcfg = arc18_configs()
    x = input_nhwc((2, 112, 112, 3))
    jmodel = jax_msml(jcfg, policy=JAX_F32, external_header=True)
    v = random_variables(jmodel, x, train=False)
    feat, seg = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(v, x)
    feat, seg = np.asarray(feat), np.asarray(seg)

    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu")
    model.load_state_dict(convert.state_dict_from_jax(v["params"],
                                                      v["batch_stats"]),
                          strict=True)
    with torch.inference_mode():
        tfeat, tseg = model(nchw(x))
    got = tfeat.numpy()
    cos = (got * feat).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(feat, axis=1))
    assert cos.min() > 0.9999, cos
    assert tseg.shape == (2, 2, 112, 112)
    np.testing.assert_allclose(to_nhwc(tseg), seg, atol=1e-4, rtol=0)
