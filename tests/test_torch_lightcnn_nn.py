"""The LightCNN-29v2 FRB's modules (configs/lightcnn_msml.yaml) in the port
against their flax counterparts: `mfm`, `Group`, `MfmResblock`,
`max_avg_pool2`, the `LightCNN29v2` trunk with its FM hooks and the frozen
`PeerLightCNN` teacher (the recipe's MSML forwards:
tests/test_torch_lightcnn_msml.py).

Both sides run in float32 on the CPU from the same numpy-drawn weights
(`test_torch_nn.random_variables`, carried by `msml_torch.tools.convert`):
the mfm convs and the blocks at small maps, B = 2; the trunk and the
teacher at full width (48 / 96 / 192 / 128 channels, 128 x 128 x 1 input,
a 256-d feature) but one resblock per stage, layers (1, 1, 1, 1), for time.
Tolerances: the modules' outputs atol 1e-5 (test_torch_nn's ATOL); the
trunk's and the teacher's features and the teacher's pooled stage features
relative L2 error <= 1e-5 (no normalization anywhere in LightCNN, so the
stage features grow to tens and an absolute bound would not fit).
"""

import numpy as np
import pytest
import torch

from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.nn import common as jcommon
from msml_tpu.nn import fm as jfm
from msml_tpu.nn import lightcnn as jlightcnn
from msml_torch.nn import common, fm, lightcnn
from msml_torch.tools import convert
from test_torch_nn import (ATOL, emitted, input_nhwc, nchw, random_variables,
                           to_nhwc)

SHALLOW = (1, 1, 1, 1)
FEATURE_RTOL = 1e-5  # relative L2 error of the 256-d features


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: in the parallel test run each worker process
    shares the cores with five others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def mfm_walk(e, dst, path):
    e.conv(dst + ".filter", path + ("filter",), bias=True)


def group_walk(e, dst, path):
    mfm_walk(e, dst + ".conv_a", path + ("conv_a",))
    mfm_walk(e, dst + ".conv", path + ("conv",))


def block_walk(e, dst, path):
    mfm_walk(e, dst + ".conv1", path + ("conv1",))
    mfm_walk(e, dst + ".conv2", path + ("conv2",))


@pytest.mark.parametrize("c_in,c_out,k,p", [(1, 48, 5, 2), (48, 48, 1, 0),
                                            (96, 96, 3, 1), (16, 8, 3, 1)],
                         ids=["conv1", "1x1", "3x3", "narrow"])
def test_mfm(c_in, c_out, k, p):
    """The conv to 2C and the max of the first C channels against the
    second, in the reference's channel order."""
    x = input_nhwc((2, 9, 9, c_in))
    jmod = jlightcnn.mfm(c_out, k, 1, p)
    v = random_variables(jmod, x)
    want = np.asarray(jmod.apply(v, x))
    m = lightcnn.MFM(c_in, c_out, k, 1, p)
    m.load_state_dict(emitted(lambda e: mfm_walk(e, "m", ()), v),
                      strict=True)
    got = to_nhwc(m(nchw(x)))
    assert got.shape == want.shape == (2, 9, 9, c_out)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_group():
    x = input_nhwc((2, 8, 8, 48))
    jmod = jlightcnn.Group(96)
    v = random_variables(jmod, x)
    want = np.asarray(jmod.apply(v, x))
    m = lightcnn.Group(48, 96)
    m.load_state_dict(emitted(lambda e: group_walk(e, "m", ()), v),
                      strict=True)
    np.testing.assert_allclose(to_nhwc(m(nchw(x))), want, atol=ATOL, rtol=0)


def test_mfm_resblock():
    x = input_nhwc((2, 8, 8, 48))
    jmod = jlightcnn.MfmResblock(48)
    v = random_variables(jmod, x)
    want = np.asarray(jmod.apply(v, x))
    m = lightcnn.MfmResblock(48)
    m.load_state_dict(emitted(lambda e: block_walk(e, "m", ()), v),
                      strict=True)
    np.testing.assert_allclose(to_nhwc(m(nchw(x))), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw", [8, 64])
def test_max_avg_pool2(hw):
    x = input_nhwc((2, hw, hw, 6))
    want = np.asarray(jcommon.max_avg_pool2(x))
    np.testing.assert_allclose(to_nhwc(common.max_avg_pool2(nchw(x))), want,
                               atol=ATOL, rtol=0)


def trunk_pair(fm_ops_jax=None, fm_ops_port=None, seed=0):
    """-> (JAX LightCNN29v2 and its variables, the port's with them) at full
    width, layers (1, 1, 1, 1)."""
    x = input_nhwc((2, 128, 128, 1))
    jmod = jlightcnn.LightCNN29v2(
        layers=SHALLOW, fm_ops=fm_ops_jax or [jfm.FMNone()
                                              for _ in range(4)],
        policy=JAX_F32)
    v = random_variables(jmod, x, (None,) * 4, (None,) * 4, False, seed=seed)
    m = lightcnn.LightCNN29v2(layers=SHALLOW, fm_ops=fm_ops_port or [
        fm.FMNone() for _ in range(4)])
    m.load_state_dict(emitted(lambda e: convert._lightcnn(e, "m", ()), v),
                      strict=True)
    return jmod, v, m


def test_lightcnn29v2_feature():
    """The trunk with FMNone hooks: the 256-d float32 feature, kd 0."""
    x = input_nhwc((2, 128, 128, 1), seed=3)
    jmod, v, m = trunk_pair()
    want, jkd = jmod.apply(v, x, (None,) * 4, (None,) * 4, False)
    got, kd = m(nchw(x), (None,) * 4)
    assert got.shape == (2, 256) and got.dtype == torch.float32
    assert kd == 0.0 and float(jkd) == 0.0
    assert rel_l2(got.detach().numpy(), np.asarray(want)) <= FEATURE_RTOL


def test_lightcnn29v2_state_dict_names():
    """The reference's torch names (`msml_tpu/tools/export_torch.py:
    188-223`) at the recipe's depth: one mfm `filter` per conv, 29 layers'
    worth of convs and `fc`."""
    m = lightcnn.LightCNN29v2(fm_ops=[fm.FMNone() for _ in range(4)])
    keys = list(m.state_dict())
    assert keys[:2] == ["conv1.filter.weight", "conv1.filter.bias"]
    assert keys[-2:] == ["fc.weight", "fc.bias"]
    convs = [k[:-len(".filter.weight")] for k in keys
             if k.endswith(".filter.weight")]
    assert len(convs) == 1 + 2 * (1 + 2 + 3 + 4) + 2 * 4
    for stage, n in zip((1, 2, 3, 4), lightcnn.LIGHTCNN29_LAYERS):
        assert f"block{stage}.{n - 1}.conv2" in convs
        assert f"block{stage}.{n}.conv1" not in convs
        assert {f"group{stage}.conv_a", f"group{stage}.conv"} <= set(convs)
    assert tuple(m.fc.weight.shape) == (256, 8 * 8 * 128)


def test_lightcnn29v2_fm_hooks():
    """The four FM hooks at 64 x 64 x 48, 32 x 32 x 96, 16 x 16 x 192 and
    8 x 8 x 128 (FMCnn [3, 2, tanh, add], the recipe's), fed by segments of
    18 channels."""
    x = input_nhwc((2, 128, 128, 1), seed=3)
    segs = [input_nhwc((2, s, s, 18), seed=10 + i)
            for i, s in enumerate((64, 32, 16, 8))]
    chans = (48, 96, 192, 128)
    jops = [jfm.FMCnn(c, 3, 2, "tanh", "add", policy=JAX_F32) for c in chans]
    ops = [fm.FMCnn(c, kernel_size=3, resblocks=2, activation="tanh",
                    arith_strategy="add") for c in chans]
    jmod = jlightcnn.LightCNN29v2(layers=SHALLOW, fm_ops=jops,
                                  policy=JAX_F32)
    v = random_variables(jmod, x, segs, (None,) * 4, False)
    want, _ = jmod.apply(v, x, segs, (None,) * 4, False)
    m = lightcnn.LightCNN29v2(layers=SHALLOW, fm_ops=ops).eval()

    def walk(e):
        convert._lightcnn(e, "m", ())
        for i in range(4):
            convert._fm(e, f"m.fm_ops.{i}", (f"fm_ops_{i}",))

    m.load_state_dict(emitted(walk, v), strict=True)
    with torch.no_grad():
        got, kd = m(nchw(x), [nchw(s) for s in segs])
    assert kd == 0.0
    assert rel_l2(got.numpy(), np.asarray(want)) <= FEATURE_RTOL


def peer_pair():
    x = input_nhwc((2, 128, 128, 1), seed=5)
    jmod = jlightcnn.PeerLightCNN(layers=SHALLOW, policy=JAX_F32)
    v = random_variables(jmod, x)
    feat, inters = jmod.apply(v, x)
    m = lightcnn.PeerLightCNN(layers=SHALLOW)
    m.load_state_dict(emitted(lambda e: convert._lightcnn(e, "m", ()), v),
                      strict=True)
    return x, np.asarray(feat), [np.asarray(t) for t in inters], m


def test_peer_lightcnn():
    """The teacher's 4 pooled stage features and its feature, without
    gradient."""
    x, feat, inters, m = peer_pair()
    got, got_inters = m(nchw(x).requires_grad_(True))
    assert not got.requires_grad and len(got_inters) == 4
    for g, w, shape in zip(got_inters, inters, ((48, 64), (96, 32),
                                                (192, 16), (128, 8))):
        assert not g.requires_grad
        assert tuple(g.shape) == (2, shape[0], shape[1], shape[1])
        assert rel_l2(to_nhwc(g), w) <= FEATURE_RTOL
    assert rel_l2(got.numpy(), feat) <= FEATURE_RTOL


def test_peer_lightcnn_stays_frozen():
    """model.train() leaves the teacher in eval mode with no parameter that
    wants a gradient; a forward changes none of its tensors."""
    _, _, _, m = peer_pair()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    parent = torch.nn.Sequential(m).train()
    assert parent.training and not any(mod.training for mod in m.modules())
    assert not any(p.requires_grad for p in m.parameters())
    m(torch.randn(1, 1, 128, 128))
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_trunk_and_teacher_share_their_names():
    """The student's trunk and the teacher carry the same keys (the
    teacher's under `frb.peer.` in the MSML), so `peer_weights` can fill
    one from the other."""
    student = lightcnn.LightCNN29v2(fm_ops=[fm.FMNone() for _ in range(4)])
    teacher = lightcnn.PeerLightCNN()
    assert list(student.state_dict()) == list(teacher.state_dict())
