"""The peer-KD recipe's modules (configs/arc18_msml_peer_dec.yaml) in the
port against their flax counterparts: the peer-guided FMCnn, the frozen
PeerIResNet teacher and the recover decoder (the recipe's MSML forwards:
tests/test_torch_peer_msml.py).

Both sides run in float32 on the CPU from the same numpy-drawn weights
(`test_torch_nn.random_variables`, carried by `msml_torch.tools.convert`),
at small sizes: FMs at C = 16 on 7 x 7 maps, B = 2; the teacher at one
block per iResNet stage, B = 2 at 112 x 112; the decoder at 32 input
channels. Tolerances: the FMs' outputs and BN statistics atol 1e-5
(test_torch_nn's ATOL), kd rtol 1e-4; the teacher's stage features atol
1e-4 and its feature by cosine >= 0.9999 (as test_torch_nn's eval
forward); the decoder's output atol 1e-5, its loss rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
from msml_tpu.nn import decoder as jdecoder
from msml_tpu.nn import fm as jfm
from msml_tpu.nn import iresnet as jiresnet
from msml_torch.nn import decoder, fm, iresnet
from msml_torch.tools import convert
from test_torch_nn import (ATOL, emitted, input_nhwc, nchw, random_variables,
                           to_nhwc)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: in the parallel test run each worker process
    shares the cores with five others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def shallow():
    """iresnet18 cut to one block per stage in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jiresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        mp.setitem(iresnet.IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        yield


def assert_stats_equal(module, variables, updates):
    """The port module's running statistics against flax's updated
    batch_stats, carried to torch names by convert's FM walk."""
    want = emitted(lambda e: convert._fm(e, "m", ()),
                   {"params": variables["params"],
                    "batch_stats": updates["batch_stats"]})
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    got = module.state_dict()
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=ATOL, rtol=0, err_msg=k)


PEER_FMS = [dict(use_ori=False)] + [
    dict(use_ori=True, use_conv=c, mask_trans=t, kd_metric=k)
    for c in (True, False) for t in ("conv", "invert") for k in (True, False)]


def fm_pair(arith, **peer):
    jmod = jfm.FMCnn(16, 3, 2, "sigmoid", arith, policy=JAX_F32, **peer)
    return jmod, fm.FMCnn(16, kernel_size=3, resblocks=2,
                          activation="sigmoid", arith_strategy=arith, **peer)


def run_fm(arith, train, **peer):
    """-> (JAX's z, kd, its variables, its updated stats or None; the
    port module, its z and kd)."""
    yf = input_nhwc((2, 7, 7, 16))
    yo = input_nhwc((2, 7, 7, 18), seed=2)
    yt = input_nhwc((2, 7, 7, 16), seed=3) if train else None
    jmod, m = fm_pair(arith, **peer)
    v = random_variables(jmod, yf, yo, yt, train)
    if train:
        (want, jkd), upd = jmod.apply(v, yf, yo, yt, True,
                                      mutable=["batch_stats"])
    else:
        (want, jkd), upd = jmod.apply(v, yf, yo, None, False), None
    m.load_state_dict(emitted(lambda e: convert._fm(e, "m", ()), v),
                      strict=True)
    m.train(train)
    got, kd = m(nchw(yf), nchw(yo), None if yt is None else nchw(yt))
    return np.asarray(want), jkd, v, upd, m, to_nhwc(got), kd


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("peer", PEER_FMS, ids=lambda p: "-".join(
    f"{k}={v}" for k, v in p.items()))
def test_fmcnn_peer(peer, train):
    """The FM with and without the peer path, conv_m or invert, the towers
    or not, the KD term on or off, in eval (no teacher feature) and in
    train (a teacher feature, BatchNorm on batch statistics)."""
    want, jkd, v, upd, m, got, kd = run_fm("mul", train, **peer)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if jkd is None:
        assert kd is None
    else:
        assert train and peer.get("kd_metric", True)
        np.testing.assert_allclose(kd.item(), float(jkd), rtol=1e-4, atol=0)
        assert kd.dtype == torch.float32 and kd.item() > 0
    if train:
        assert_stats_equal(m, v, upd)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arith", ["add", "sub", "div", "mul"])
def test_fmcnn_peer_arith(arith, train):
    """The recipe's FM (use_conv, conv_m, KD) under each arith."""
    want, jkd, _, _, m, got, kd = run_fm(arith, train, use_ori=True,
                                        use_conv=True, mask_trans="conv")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (kd is None) == (jkd is None) == (not train)
    if train:
        np.testing.assert_allclose(kd.item(), float(jkd), rtol=1e-4, atol=0)


def test_fmcnn_holds_the_kd_tower_without_kd_metric():
    """kd_metric off: the conv2 tower is not run but its parameters exist
    on both sides (JAX creates them at init), and the state dicts agree
    key for key."""
    yf = input_nhwc((2, 7, 7, 16))
    yo = input_nhwc((2, 7, 7, 18), seed=2)
    jmod, m = fm_pair("mul", use_ori=True, use_conv=True, kd_metric=False)
    v = random_variables(jmod, yf, yo, None, False)
    assert "conv2" in v["params"]
    sd = emitted(lambda e: convert._fm(e, "m", ()), v)
    assert set(sd) == set(m.state_dict())
    assert any(k.startswith("conv2.") for k in sd)


def test_fmcnn_rejects_a_bad_mask_trans():
    with pytest.raises(ValueError, match="mask_trans"):
        fm.FMCnn(16, use_ori=True, mask_trans="identity")


def peer_pair():
    x = input_nhwc((2, 112, 112, 3))
    jmod = jiresnet.PeerIResNet(layers=(1, 1, 1, 1), policy=JAX_F32)
    v = random_variables(jmod, x)
    feat, inters = jmod.apply(v, x)
    m = iresnet.PeerIResNet(layers=(1, 1, 1, 1))
    m.load_state_dict(emitted(lambda e: convert._iresnet(e, "m", ()), v),
                      strict=True)
    return x, np.asarray(feat), [np.asarray(t) for t in inters], m


def test_peer_iresnet():
    """The teacher's 4 stage features and its feature, from the running
    statistics, without gradient."""
    x, feat, inters, m = peer_pair()
    xt = nchw(x).requires_grad_(True)
    got, got_inters = m(xt)
    assert not got.requires_grad
    assert len(got_inters) == 4
    for g, w in zip(got_inters, inters):
        assert not g.requires_grad
        np.testing.assert_allclose(to_nhwc(g), w, atol=1e-4, rtol=0)
    got = got.numpy()
    cos = (got * feat).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(feat, axis=1))
    assert cos.min() > 0.9999, cos


def test_peer_iresnet_stays_in_eval_mode():
    """model.train() leaves the teacher in eval mode: a forward in the
    parent's train mode changes none of its BN statistics, and it has no
    parameter that wants a gradient."""
    _, _, _, m = peer_pair()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    parent = torch.nn.Sequential(m).train()
    assert parent.training
    assert not any(mod.training for mod in m.modules())
    assert not any(p.requires_grad for p in m.parameters())
    m(torch.randn(2, 3, 112, 112))
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_decoder():
    """DeepMindDecoder: the 112 x 112 x 3 recovery of a 7 x 7 map and its
    float32 L2 loss against `ori` (0.0 without it)."""
    x = input_nhwc((2, 7, 7, 32))
    ori = input_nhwc((2, 112, 112, 3), seed=4)
    jmod = jdecoder.DeepMindDecoder(n_init=32, policy=JAX_F32)
    v = random_variables(jmod, x, ori)
    rec, loss = jmod.apply(v, x, ori)
    m = decoder.DeepMindDecoder(n_init=32)
    sd = emitted(lambda e: convert._decoder(e, "m", ()), v)
    m.load_state_dict(sd, strict=True)
    got, got_loss = m(nchw(x), nchw(ori))
    assert got.shape == (2, 3, 112, 112)
    np.testing.assert_allclose(to_nhwc(got.detach()), np.asarray(rec),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-4,
                               atol=0)
    assert m(nchw(x))[1] == 0.0
