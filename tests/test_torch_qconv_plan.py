"""The launch plan of the int8 conv kernel (`msml_torch/kernels/qconv.py::
qconv_plan`), replayed in numpy as the kernel walks it.

The plan is read back from the int32 array the wrapper hands the C entry
point (`QConvPlan.array`). Each phase runs as a stride-`step` sub-conv of
the undilated input over only its taps; each block's K slice runs stage by
stage, each thread's 16-byte piece advancing its (tap, channel) by the
kernel's additions; the slices' int64 partial sums add up. The replay is
held bit for bit to `qconv_reference` (itself held to the JAX package's
int8 ops in tests/test_torch_quantize.py), and the plan of every int8 site
of arc18_msml is checked for what the kernel relies on.
"""

import numpy as np
import pytest
import torch

from msml_torch.kernels import qconv

# arc18_msml's int8 sites (configs/arc18_msml.yaml, bf16): kind, input (C,
# H, W) or (C,), output channels, geometry (kh, kw, sh, sw, ph, pw, dh, dw,
# ho, wo), sites with that key, the first site
SITES = [
    ("conv", (64, 56, 56), 64, (3, 3, 1, 1, 1, 1, 1, 1, 56, 56), 3, "osb.layer1.0.conv1"),
    ("conv", (64, 56, 56), 64, (3, 3, 2, 2, 1, 1, 1, 1, 28, 28), 1, "osb.layer1.0.conv2"),
    ("conv", (64, 56, 56), 64, (1, 1, 2, 2, 0, 0, 1, 1, 28, 28), 1, "osb.layer1.0.downsample.0"),
    ("conv", (64, 28, 28), 64, (3, 3, 1, 1, 1, 1, 1, 1, 28, 28), 4, "osb.layer1.1.conv1"),
    ("conv", (64, 28, 28), 128, (3, 3, 1, 1, 1, 1, 1, 1, 28, 28), 1, "osb.layer2.0.conv1"),
    ("conv", (128, 28, 28), 128, (3, 3, 2, 2, 1, 1, 1, 1, 14, 14), 1, "osb.layer2.0.conv2"),
    ("conv", (64, 28, 28), 128, (1, 1, 2, 2, 0, 0, 1, 1, 14, 14), 1, "osb.layer2.0.downsample.0"),
    ("conv", (128, 14, 14), 128, (3, 3, 1, 1, 1, 1, 1, 1, 14, 14), 4, "osb.layer2.1.conv1"),
    ("conv", (128, 14, 14), 256, (3, 3, 1, 1, 1, 1, 1, 1, 14, 14), 1, "osb.layer3.0.conv1"),
    ("conv", (256, 14, 14), 256, (3, 3, 2, 2, 1, 1, 1, 1, 7, 7), 1, "osb.layer3.0.conv2"),
    ("conv", (128, 14, 14), 256, (1, 1, 2, 2, 0, 0, 1, 1, 7, 7), 1, "osb.layer3.0.downsample.0"),
    ("conv", (256, 7, 7), 256, (3, 3, 1, 1, 1, 1, 1, 1, 7, 7), 2, "osb.layer3.1.conv1"),
    ("conv", (256, 7, 7), 512, (3, 3, 1, 1, 1, 1, 1, 1, 7, 7), 1, "osb.layer4.0.conv1"),
    ("conv", (512, 7, 7), 512, (3, 3, 2, 2, 1, 1, 1, 1, 4, 4), 1, "osb.layer4.0.conv2"),
    ("conv", (256, 7, 7), 512, (1, 1, 2, 2, 0, 0, 1, 1, 4, 4), 1, "osb.layer4.0.downsample.0"),
    ("conv", (512, 4, 4), 512, (3, 3, 1, 1, 1, 1, 1, 1, 4, 4), 2, "osb.layer4.1.conv1"),
    ("conv", (512, 4, 4), 8, (7, 1, 1, 1, 3, 0, 1, 1, 4, 4), 1, "osb.gcm1.conv_l1"),
    ("conv", (512, 4, 4), 8, (1, 7, 1, 1, 0, 3, 1, 1, 4, 4), 1, "osb.gcm1.conv_r1"),
    ("transposed", (8, 4, 4), 18, (3, 3, 1, 1, 1, 1, 2, 2, 7, 7), 1, "osb.deconv1"),
    ("conv", (256, 7, 7), 18, (7, 1, 1, 1, 3, 0, 1, 1, 7, 7), 1, "osb.gcm2.conv_l1"),
    ("conv", (18, 7, 7), 18, (1, 7, 1, 1, 0, 3, 1, 1, 7, 7), 1, "osb.gcm2.conv_l2"),
    ("conv", (256, 7, 7), 18, (1, 7, 1, 1, 0, 3, 1, 1, 7, 7), 1, "osb.gcm2.conv_r1"),
    ("conv", (18, 7, 7), 18, (7, 1, 1, 1, 3, 0, 1, 1, 7, 7), 1, "osb.gcm2.conv_r2"),
    ("transposed", (36, 7, 7), 18, (4, 4, 1, 1, 2, 2, 2, 2, 14, 14), 1, "osb.deconv2"),
    ("conv", (128, 14, 14), 18, (7, 1, 1, 1, 3, 0, 1, 1, 14, 14), 1, "osb.gcm3.conv_l1"),
    ("conv", (18, 14, 14), 18, (1, 7, 1, 1, 0, 3, 1, 1, 14, 14), 1, "osb.gcm3.conv_l2"),
    ("conv", (128, 14, 14), 18, (1, 7, 1, 1, 0, 3, 1, 1, 14, 14), 1, "osb.gcm3.conv_r1"),
    ("conv", (18, 14, 14), 18, (7, 1, 1, 1, 3, 0, 1, 1, 14, 14), 1, "osb.gcm3.conv_r2"),
    ("transposed", (36, 14, 14), 18, (4, 4, 1, 1, 2, 2, 2, 2, 28, 28), 1, "osb.deconv3"),
    ("conv", (64, 28, 28), 18, (7, 1, 1, 1, 3, 0, 1, 1, 28, 28), 1, "osb.gcm4.conv_l1"),
    ("conv", (18, 28, 28), 18, (1, 7, 1, 1, 0, 3, 1, 1, 28, 28), 1, "osb.gcm4.conv_l2"),
    ("conv", (64, 28, 28), 18, (1, 7, 1, 1, 0, 3, 1, 1, 28, 28), 1, "osb.gcm4.conv_r1"),
    ("conv", (18, 28, 28), 18, (7, 1, 1, 1, 3, 0, 1, 1, 28, 28), 1, "osb.gcm4.conv_r2"),
    ("transposed", (36, 28, 28), 18, (4, 4, 1, 1, 2, 2, 2, 2, 56, 56), 1, "osb.deconv4"),
    ("conv", (64, 56, 56), 18, (7, 1, 1, 1, 3, 0, 1, 1, 56, 56), 1, "osb.gcm5.conv_l1"),
    ("conv", (18, 56, 56), 18, (1, 7, 1, 1, 0, 3, 1, 1, 56, 56), 1, "osb.gcm5.conv_l2"),
    ("conv", (64, 56, 56), 18, (1, 7, 1, 1, 0, 3, 1, 1, 56, 56), 1, "osb.gcm5.conv_r1"),
    ("conv", (18, 56, 56), 18, (7, 1, 1, 1, 3, 0, 1, 1, 56, 56), 1, "osb.gcm5.conv_r2"),
    ("transposed", (36, 56, 56), 18, (4, 4, 1, 1, 2, 2, 2, 2, 112, 112), 1, "osb.deconv5"),
    ("conv", (64, 112, 112), 64, (3, 3, 1, 1, 1, 1, 1, 1, 112, 112), 1, "frb.layer1.0.conv1"),
    ("conv", (64, 112, 112), 64, (3, 3, 2, 2, 1, 1, 1, 1, 56, 56), 1, "frb.layer1.0.conv2"),
    ("conv", (64, 112, 112), 64, (1, 1, 2, 2, 0, 0, 1, 1, 56, 56), 1, "frb.layer1.0.downsample.0"),
    ("conv", (82, 56, 56), 64, (3, 3, 1, 1, 1, 1, 1, 1, 56, 56), 1, "frb.fm_ops.0.same_conv"),
    ("conv", (64, 56, 56), 32, (1, 1, 1, 1, 0, 0, 1, 1, 56, 56), 2, "frb.fm_ops.0.res_block.0.conv1"),
    ("conv", (32, 56, 56), 32, (3, 3, 1, 1, 1, 1, 1, 1, 56, 56), 2, "frb.fm_ops.0.res_block.0.conv2"),
    ("conv", (64, 56, 56), 128, (3, 3, 1, 1, 1, 1, 1, 1, 56, 56), 1, "frb.layer2.0.conv1"),
    ("conv", (128, 56, 56), 128, (3, 3, 2, 2, 1, 1, 1, 1, 28, 28), 1, "frb.layer2.0.conv2"),
    ("conv", (64, 56, 56), 128, (1, 1, 2, 2, 0, 0, 1, 1, 28, 28), 1, "frb.layer2.0.downsample.0"),
    ("conv", (128, 28, 28), 128, (3, 3, 1, 1, 1, 1, 1, 1, 28, 28), 2, "frb.layer2.1.conv1"),
    ("conv", (146, 28, 28), 128, (3, 3, 1, 1, 1, 1, 1, 1, 28, 28), 1, "frb.fm_ops.1.same_conv"),
    ("conv", (128, 28, 28), 64, (1, 1, 1, 1, 0, 0, 1, 1, 28, 28), 2, "frb.fm_ops.1.res_block.0.conv1"),
    ("conv", (64, 28, 28), 128, (1, 1, 1, 1, 0, 0, 1, 1, 28, 28), 2, "frb.fm_ops.1.res_block.0.conv3"),
    ("conv", (128, 28, 28), 256, (3, 3, 1, 1, 1, 1, 1, 1, 28, 28), 1, "frb.layer3.0.conv1"),
    ("conv", (256, 28, 28), 256, (3, 3, 2, 2, 1, 1, 1, 1, 14, 14), 1, "frb.layer3.0.conv2"),
    ("conv", (128, 28, 28), 256, (1, 1, 2, 2, 0, 0, 1, 1, 14, 14), 1, "frb.layer3.0.downsample.0"),
    ("conv", (256, 14, 14), 256, (3, 3, 1, 1, 1, 1, 1, 1, 14, 14), 2, "frb.layer3.1.conv1"),
    ("conv", (274, 14, 14), 256, (3, 3, 1, 1, 1, 1, 1, 1, 14, 14), 1, "frb.fm_ops.2.same_conv"),
    ("conv", (256, 14, 14), 128, (1, 1, 1, 1, 0, 0, 1, 1, 14, 14), 2, "frb.fm_ops.2.res_block.0.conv1"),
    ("conv", (128, 14, 14), 256, (1, 1, 1, 1, 0, 0, 1, 1, 14, 14), 2, "frb.fm_ops.2.res_block.0.conv3"),
    ("conv", (256, 14, 14), 512, (3, 3, 1, 1, 1, 1, 1, 1, 14, 14), 1, "frb.layer4.0.conv1"),
    ("conv", (512, 14, 14), 512, (3, 3, 2, 2, 1, 1, 1, 1, 7, 7), 1, "frb.layer4.0.conv2"),
    ("conv", (256, 14, 14), 512, (1, 1, 2, 2, 0, 0, 1, 1, 7, 7), 1, "frb.layer4.0.downsample.0"),
    ("conv", (512, 7, 7), 512, (3, 3, 1, 1, 1, 1, 1, 1, 7, 7), 2, "frb.layer4.1.conv1"),
    ("conv", (530, 7, 7), 512, (3, 3, 1, 1, 1, 1, 1, 1, 7, 7), 1, "frb.fm_ops.3.same_conv"),
    ("conv", (512, 7, 7), 128, (1, 1, 1, 1, 0, 0, 1, 1, 7, 7), 2, "frb.fm_ops.3.res_block.0.conv1"),
    ("conv", (128, 7, 7), 128, (3, 3, 1, 1, 1, 1, 1, 1, 7, 7), 2, "frb.fm_ops.3.res_block.0.conv2"),
    ("conv", (128, 7, 7), 512, (1, 1, 1, 1, 0, 0, 1, 1, 7, 7), 2, "frb.fm_ops.3.res_block.0.conv3"),
    ("linear", (25088,), 512, (1, 1, 1, 1, 0, 0, 1, 1, 1, 1), 1, "frb.fc"),
]
B_MAIN = 512  # the quantized eval forward's batch
FC = (1, 1, 1, 1, 0, 0, 1, 1, 1, 1)


def read_plan(arr: np.ndarray) -> dict:
    """The plan as the C entry point reads it."""
    head = [int(v) for v in arr[:11]]
    keys = ("bm", "bn", "splits", "kt_per", "ty", "tx", "sy", "sx", "nph",
            "ntm", "ntp")
    plan = dict(zip(keys, head))
    plan["phases"] = [qconv.Phase(*map(int, r))
                      for r in arr[11:].reshape(plan["nph"], 10)]
    return plan


def pieces(plan: dict, f: qconv.Phase, cp: int):
    """(slice, tap i, tap j, channel) of every 16-byte piece the kernel's
    threads load for phase f: piece q of each stage starts at K = kt0 BK +
    16 q and moves by BK bytes a stage, (tap, channel) by additions."""
    bk = qconv.BK
    kt_all = -(-f.nky * f.nkx * cp // bk)
    for z in range(plan["splits"]):
        kt0 = z * plan["kt_per"]
        nkt = max(0, min(kt_all, kt0 + plan["kt_per"]) - kt0)
        for q in range(bk // 16):
            if nkt == 0:
                continue
            k = kt0 * bk + 16 * q
            t, ci = divmod(k, cp)
            ty, tx = divmod(t, f.nkx)
            for _ in range(nkt):
                if ty < f.nky:
                    yield z, ty, tx, ci
                ci += bk
                while ci >= cp:
                    ci -= cp
                    tx += 1
                    if tx == f.nkx:
                        tx, ty = 0, ty + 1


def replay(xq: np.ndarray, wp: np.ndarray, co: int, geometry, arr):
    """int64 sums (splits, N, Co, Ho, Wo) of the plan's phases and K
    slices, and how often each output was written."""
    plan = read_plan(arr)
    kh, kw, _, _, _, _, dh, dw, ho, wo = geometry
    n, h, w, cp = xq.shape
    wt = wp[:co].astype(np.int64).reshape(co, kh, kw, cp)
    x = xq.astype(np.int64)
    acc = np.zeros((plan["splits"], n, co, ho, wo), np.int64)
    written = np.zeros((ho, wo), np.int64)
    for f in plan["phases"]:
        jy, jx = np.arange(f.ho), np.arange(f.wo)
        oy, ox = f.ry + plan["ty"] * jy, f.rx + plan["tx"] * jx
        written[np.ix_(oy, ox)] += 1
        for z, i, j, ci in pieces(plan, f, cp):
            iy = f.iy0 + plan["sy"] * jy + i
            ix = f.ix0 + plan["sx"] * jx + j
            oky, okx = (iy >= 0) & (iy < h), (ix >= 0) & (ix < w)
            patch = x[:, np.clip(iy, 0, h - 1)][:, :, np.clip(ix, 0, w - 1),
                                               ci:ci + 16]
            patch = patch * (oky[:, None] & okx[None, :])[None, :, :, None]
            tap = wt[:, f.ky0 + dh * i, f.kx0 + dw * j, ci:ci + 16]
            acc[z][np.ix_(np.arange(n), np.arange(co), oy, ox)] += np.einsum(
                "nyxc,oc->noyx", patch, tap)
    return acc, written


def operands(n, ci, h, w, co, kh, kw, dtype, seed):
    """quant_act's codes of a seeded input, packed seeded weights, sw,
    bias."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, ci, h, w).astype(np.float32))
    x[0] *= 4.0
    cp = qconv.padded_channels(ci)
    xq, sx = qconv.quant_act_reference(x.to(dtype), cp)
    wq = torch.from_numpy(rng.randint(-127, 128, (co, ci, kh, kw))
                          .astype(np.int8))
    sw = torch.from_numpy((rng.rand(co) * 0.01 + 1e-4).astype(np.float32))
    bias = torch.from_numpy(rng.randn(co).astype(np.float32))
    return xq, qconv.pack_weight(wq, cp), sx, sw, bias


def site_id(site):
    return site[5]


@pytest.mark.parametrize("site", SITES, ids=site_id)
def test_plan_of_each_site(site):
    """What the kernel relies on, at B = 512: a compiled tile whose rows
    stay inside the 64-row packing, phases that write each output once and
    whose taps land only on input rows and columns (no hole), pixel tiles
    that cover every phase, and K slices whose pieces load each (tap,
    16 channels) of a phase exactly once."""
    kind, shape, co, geometry, _, _ = site
    cp = qconv.padded_channels(shape[0])
    kh, kw, sh, swd, ph, pw, dh, dw, ho, wo = geometry
    plan = qconv.qconv_plan(B_MAIN, cp, co, geometry)
    got = read_plan(plan.array())
    assert (got["bm"], got["bn"]) in qconv.TILES
    assert got["ntm"] == -(-co // got["bm"])
    assert got["ntm"] * got["bm"] <= -(-co // qconv.W_ROWS) * qconv.W_ROWS
    assert 1 <= got["nph"] <= qconv.MAX_PHASES
    assert got["splits"] == 1 or got["ntm"] * got["nph"] * got["ntp"] < \
        qconv.SMS
    written = np.zeros((ho, wo), np.int64)
    for f in got["phases"]:
        assert B_MAIN * f.ho * f.wo <= got["ntp"] * got["bn"]
        oy = f.ry + got["ty"] * np.arange(f.ho)
        ox = f.rx + got["tx"] * np.arange(f.wo)
        written[np.ix_(oy, ox)] += 1
        for axis in ((oy, f.ky0, f.nky, dh, sh, ph, f.iy0, got["sy"]),
                     (ox, f.kx0, f.nkx, dw, swd, pw, f.ix0, got["sx"])):
            o, k0, nk, dil, stride, pad, i0, step = axis
            taps = k0 + dil * np.arange(nk)
            v = o[:, None] * stride - pad + taps[None, :]
            assert (v % dil == 0).all()   # every tap lands on the input
            np.testing.assert_array_equal(
                v // dil, i0 + step * np.arange(len(o))[:, None]
                + np.arange(nk)[None, :])
            # and none that lands is left out
            all_taps = np.arange(kh if axis[0] is oy else kw)
            lands = (o[:, None] * stride - pad + all_taps[None, :]) % dil == 0
            assert lands.sum(1).tolist() == [nk] * len(o)
        loaded = [(i, j, ci) for _, i, j, ci in pieces(got, f, cp)]
        want = [(i, j, ci) for i in range(f.nky) for j in range(f.nkx)
                for ci in range(0, cp, 16)]
        assert sorted(loaded) == want
    assert (written == 1).all()


def test_sites_are_arc18_msml():
    """SITES are the int8 sites of arc18_msml's quantized eval forward."""
    from msml_torch.tools.qconv_ab import arc18_int8, int8_sites_of

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _, qmodel = arc18_int8("cpu", 0)
        found = int8_sites_of(qmodel, torch.zeros((1, 3, 112, 112)))
    finally:
        torch.set_num_threads(threads)
    assert [(k[0], k[1], k[5], k[2], len(v), v[0][0])
            for k, v in found.items()] == SITES


# (N, C_in, H, W, C_out, geometry): the transposed convs of arc18_msml at
# small N, transposed convs with odd ho and wo (phases of unequal size),
# a stride-3 and a 2 x 1 lhs dilation, a plain conv with a pixel tail
REPLAYED = {
    "deconv1": (2, 8, 4, 4, 18, (3, 3, 1, 1, 1, 1, 2, 2, 7, 7)),
    "deconv2": (2, 36, 7, 7, 18, (4, 4, 1, 1, 2, 2, 2, 2, 14, 14)),
    "deconv3": (2, 36, 14, 14, 18, (4, 4, 1, 1, 2, 2, 2, 2, 28, 28)),
    "deconv4": (1, 36, 28, 28, 18, (4, 4, 1, 1, 2, 2, 2, 2, 56, 56)),
    "deconv5": (1, 36, 56, 56, 18, (4, 4, 1, 1, 2, 2, 2, 2, 112, 112)),
    "deconv4x4_odd": (2, 36, 5, 6, 18, (4, 4, 1, 1, 2, 2, 2, 2, 9, 11)),
    "deconv3x3_odd": (3, 8, 4, 3, 18, (3, 3, 1, 1, 1, 1, 2, 2, 7, 5)),
    "dil3_odd": (2, 16, 4, 4, 40, (3, 3, 1, 1, 2, 2, 3, 3, 11, 12)),
    "dil2x1": (2, 16, 4, 5, 40, (3, 2, 1, 1, 1, 0, 2, 1, 8, 4)),
    "conv_tail": (3, 40, 5, 7, 33, (3, 3, 1, 1, 1, 1, 1, 1, 5, 7)),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", REPLAYED)
def test_replay_bit_equal_reference(case, dtype):
    """The plan replayed phase by phase and piece by piece, dequantized as
    the kernel does, equals `qconv_reference` bit for bit; every output is
    written by exactly one phase."""
    n, ci, h, w, co, geometry = REPLAYED[case]
    xq, wp, sx, sw, bias = operands(n, ci, h, w, co, *geometry[:2], dtype,
                                    seed=len(case))
    plan = qconv.qconv_plan(n, xq.shape[3], co, geometry)
    acc, written = replay(xq.numpy(), wp.numpy(), co, geometry, plan.array())
    assert (written == 1).all()
    got = qconv.dequantize(torch.from_numpy(acc.sum(0)), sx, sw, bias, dtype)
    want = qconv.qconv_reference(xq, wp, sx, sw, bias, geometry, dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,splits", [(1, None), (4, None), (3, 5), (2, 13)])
def test_split_k_slices_sum_to_whole(n, splits):
    """The fc (a 1 x 1 conv over K = 25,088): the plan's K slices (or
    `splits` of them, at a K that the count does not divide) as int64
    partial sums add up to the whole, which dequantizes to the
    reference."""
    ci, co = 25088, 64
    xq, wp, sx, sw, bias = operands(n, ci, 1, 1, co, 1, 1, torch.bfloat16,
                                    seed=n)
    plan = qconv.qconv_plan(n, ci, co, FC)
    if splits is not None:
        kt = -(-ci // qconv.BK)
        assert kt % splits
        per = -(-kt // splits)
        plan = plan._replace(splits=-(-kt // per), kt_per=per)
    assert plan.splits > 1
    acc, _ = replay(xq.numpy(), wp.numpy(), co, FC, plan.array())
    whole = np.einsum("nc,oc->no", xq.numpy()[:, 0, 0].astype(np.int64),
                      wp.numpy()[:co].astype(np.int64))
    assert (acc[:, :, :, 0, 0] != 0).any(axis=(1, 2)).all()
    np.testing.assert_array_equal(acc.sum(0)[:, :, 0, 0], whole)
    got = qconv.dequantize(torch.from_numpy(acc.sum(0)), sx, sw, bias,
                           torch.bfloat16)
    assert torch.equal(got, qconv.qconv_reference(xq, wp, sx, sw, bias, FC,
                                                  torch.bfloat16))


def test_fc_plan_splits_k():
    """The fc at B = 1, 512 and 513: a launch of fewer blocks than SMs
    splits its 392 stages of K into slices of about two blocks per SM."""
    for n, want in ((1, 24), (512, 9), (513, 8)):
        plan = qconv.qconv_plan(n, 25088, 512, FC)
        assert (plan.bm, plan.bn, plan.splits) == (128, 64, want)
        assert (plan.splits - 1) * plan.kt_per < 392 <= \
            plan.splits * plan.kt_per
        assert plan.workspace == plan.blocks * (128 * 64 + 1)
