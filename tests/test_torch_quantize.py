"""int8 post-training quantization (`msml_torch.core.quantize`, the plain
versions of `msml_torch.kernels.qconv`) against the JAX package's
`quantize_fn` on the CPU.

Per op, the same numpy-drawn inputs and weights go through `jax.jit` of
`quantize_fn` (as the JAX entry points run it) and through the port's
`quantize_model`: the int8 codes of the weights and of the activations and
the outputs are exactly equal, in float32 and under bf16, over every
geometry that the flagship quantizes (3 x 3 at strides 1 and 2, 1 x 1 at
stride 2, the GCM's 7 x 1 and 1 x 7 with their bias, C_in 18 / 82, C_out
18, the U-Net decoders' 4 x 4 and 3 x 3 transposed convs, the fc). Both
sides sum int8 products exactly in int32 and round the same way. Then the
skip rules and their counts (JAX's `stats_out`) on JAX's own small CNN of
`tests/test_quantize.py` and on arc18_msml at one block per stage, with
that model's quantized features against JAX's (`JAX_MIN_COS`) and against
its own float forward (`FLOAT_MIN_COS`), and each of its int8 sites on the
activations that JAX's jitted forward gave it; the kernel's weight packing
replayed as an im2col; and the three entry points with `--quant int8`.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax import lax
from torch import nn

from msml_tpu.core import quantize as jquant
from msml_torch.core.quantize import QuantConv, quant_sites, quantize_model
from msml_torch.kernels import qconv

# arc18_msml at one block per stage, B = 2, float32 on the CPU, numpy-drawn
# weights (seed 4). The float forwards of the two packages agree to a cosine
# of 1 - 1e-12, but a code that flips at a rounding boundary moves its
# element by a whole step, and the flips compound through the ~20
# quantizers in series: the port's quantized features against JAX's jitted
# ones measured 0.998952, and JAX's own jitted against its eager quantized
# forward 0.998959, the same distance. Against the float forward the
# quantized one measured 0.998356 (JAX's 0.998464); JAX's own bound is
# 0.998 (tests/test_quantize.py), and both comparisons are held to it.
# That bound alone would pass the float features too (0.998464 from JAX's
# int8 ones), so each image's int8 features are also held nearer JAX's
# than the float ones (measured 0.998952 / 0.999121 against 0.998719 /
# 0.998464), and each of the 82 sites, fed the activations that JAX's
# equation saw, gives JAX's codes and outputs bit for bit.
JAX_MIN_COS = 0.998
FLOAT_MIN_COS = 0.998


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads: in the parallel test run each worker process
    shares the cores with five others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class Autocast(nn.Module):
    """Runs `m` under the CPU's bf16 autocast, as the bf16 policy runs the
    model's convolutions."""

    def __init__(self, m: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.m, self.dtype = m, dtype

    def forward(self, x):
        with torch.autocast("cpu", dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            return self.m(x)


# (kind, C_in, C_out, (kh, kw), stride, (ph, pw), bias, H = W of the input)
OPS = {
    "3x3_s1": ("conv", 64, 64, (3, 3), 1, (1, 1), False, 9),
    "3x3_s2": ("conv", 64, 128, (3, 3), 2, (1, 1), False, 9),
    "1x1_s2": ("conv", 64, 128, (1, 1), 2, (0, 0), False, 9),
    "gcm_7x1": ("conv", 82, 18, (7, 1), 1, (3, 0), True, 7),
    "gcm_1x7": ("conv", 18, 18, (1, 7), 1, (0, 3), True, 7),
    "cin18_3x3": ("conv", 18, 64, (3, 3), 1, (1, 1), False, 8),
    "cin146_3x3": ("conv", 146, 128, (3, 3), 1, (1, 1), False, 5),
    "deconv_4x4": ("transposed", 36, 18, (4, 4), 2, (1, 1), False, 7),
    "deconv_3x3": ("transposed", 8, 18, (3, 3), 2, (1, 1), False, 4),
    "fc": ("linear", 25088, 512, None, None, None, True, None),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def draw_op(name, b=3, seed=0):
    """numpy x (NHWC, or (B, C) for the fc), the JAX weight (HWIO; (k, k,
    out, in) for a transposed conv; (in, out) for the fc) and bias."""
    kind, ci, co, k, _, _, bias, hw = OPS[name]
    rs = np.random.RandomState(seed)
    if kind == "linear":
        x = rs.randn(b, ci)
        w = rs.randn(ci, co) / np.sqrt(ci)
    else:
        x = rs.randn(b, hw, hw, ci)
        x[1] *= 3.0  # samples at other scales
        shape = (k + (co, ci)) if kind == "transposed" else (k + (ci, co))
        w = rs.randn(*shape) / np.sqrt(ci * k[0] * k[1])
    bvec = rs.randn(co) * 0.1 if bias else None
    f = np.float32
    return x.astype(f), w.astype(f), None if bvec is None else bvec.astype(f)


def jax_op(name, w, bias, jdt):
    kind, _, _, k, s, p, _, _ = OPS[name]
    wj = jnp.asarray(w)

    def fwd(x):
        x = x.astype(jdt)
        if kind == "linear":
            y = jnp.dot(x, wj.astype(jdt))
        elif kind == "transposed":
            pad = [(kk - 1 - pp, kk - 1 - pp) for kk, pp in zip(k, p)]
            y = lax.conv_transpose(x, wj.astype(jdt), (s, s), pad,
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   transpose_kernel=True)
        else:
            y = lax.conv_general_dilated(
                x, wj.astype(jdt), (s, s), [(pp, pp) for pp in p],
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
        if bias is not None:
            y = y + jnp.asarray(bias).astype(jdt)
        return y

    return fwd


def torch_op(name, w, bias) -> nn.Module:
    kind, ci, co, k, s, p, _, _ = OPS[name]
    if kind == "linear":
        m = nn.Linear(ci, co, bias=bias is not None)
        wt = w.T
    elif kind == "transposed":
        m = nn.ConvTranspose2d(ci, co, k, s, p, bias=bias is not None)
        wt = w.transpose(3, 2, 0, 1)
    else:
        m = nn.Conv2d(ci, co, k, s, p, bias=bias is not None)
        wt = w.transpose(3, 2, 0, 1)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.ascontiguousarray(wt)))
        if bias is not None:
            m.bias.copy_(torch.from_numpy(bias))
    return m


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        x if x.ndim == 2 else x.transpose(0, 3, 1, 2)))


def as_f32(y):
    return np.asarray(jnp.asarray(y).astype(jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", OPS)
def test_op_codes_and_outputs_equal_jax(name, dtype):
    jdt, tdt = DTYPES[dtype]
    kind = OPS[name][0]
    x, w, bias = draw_op(name)
    stats, tstats = {}, {}
    want = as_f32(jax.jit(jquant.quantize_fn(jax_op(name, w, bias, jdt),
                                             stats_out=stats))(x))
    assert stats[("dot" if kind == "linear" else "conv")
                 + "_quantized"] == 1
    qm = quantize_model(Autocast(torch_op(name, w, bias), tdt), nchw(x),
                        stats_out=tstats)
    assert tstats == stats
    assert isinstance(qm.m, QuantConv)
    with torch.no_grad():
        got = qm(nchw(x))
    assert got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_array_equal(
        got if kind == "linear" else got.transpose(0, 2, 3, 1), want)

    # the codes: JAX's weights and activations as its jitted forward makes
    # them (a cast weight is a traced value there, a float32 one a constant)
    out_axis = {"linear": 1, "transposed": 2, "conv": 3}[kind]
    wj = jnp.asarray(w)
    if jdt == jnp.float32:
        jwq, jsw = jquant._quant_weight(wj, out_axis)
    else:
        jwq, jsw = jax.jit(lambda v: jquant._quant_weight(
            v.astype(jdt), out_axis))(wj)
    wq = qconv.unpack_weight(qm.m.wp, w.shape[out_axis], *qm.m.kernel)
    wq = wq[:, :x.shape[-1]].numpy()
    if kind == "linear":
        wq = wq[:, :, 0, 0].T
    elif kind == "transposed":  # back from the conv weight: (k, k, out, in)
        wq = wq[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    else:
        wq = wq.transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(wq, np.asarray(jwq))
    np.testing.assert_array_equal(qm.m.sw.numpy(), np.asarray(jsw))
    jxq, jsx = jax.jit(lambda v: jquant._quant_act(v.astype(jdt), 0))(x)
    xq, sx = qconv.quant_act(nchw(x).to(tdt), qm.m.cp)
    np.testing.assert_array_equal(
        xq[..., :x.shape[-1]].numpy().reshape(jxq.shape), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


# ------------------------------------------- the kernel's packing, replayed

# (C_in, C_out, (kh, kw), (sh, sw), (ph, pw), (dh, dw), (H, W))
PACKING = {
    "3x3_s2": (64, 128, (3, 3), (2, 2), (1, 1), (1, 1), (9, 8)),
    "1x1_s2": (82, 64, (1, 1), (2, 2), (0, 0), (1, 1), (7, 7)),
    "7x1": (18, 18, (7, 1), (1, 1), (3, 0), (1, 1), (7, 5)),
    "1x7": (36, 18, (1, 7), (1, 1), (0, 3), (1, 1), (5, 7)),
    "deconv_4x4": (36, 18, (4, 4), (1, 1), (2, 2), (2, 2), (7, 7)),
    "deconv_3x3": (8, 18, (3, 3), (1, 1), (1, 1), (2, 2), (4, 4)),
}


def im2col_replay(xq, geometry):
    """The kernel's B operand in numpy: for output pixel (n, oy, ox) and K
    index (ky, kx, ci), xq[n, vy / dh, vx / dw, ci] with vy = oy sh - ph +
    ky where that lies on the dilated input's grid, else 0."""
    kh, kw, sh, sw, ph, pw, dh, dw, ho, wo = geometry
    n, h, w, cp = xq.shape
    cols = np.zeros((n, ho, wo, kh, kw, cp), np.int64)
    for oy in range(ho):
        for ox in range(wo):
            for ky in range(kh):
                for kx in range(kw):
                    vy, vx = oy * sh - ph + ky, ox * sw - pw + kx
                    if (vy >= 0 and vx >= 0 and vy % dh == 0 and vx % dw == 0
                            and vy // dh < h and vx // dw < w):
                        cols[:, oy, ox, ky, kx] = xq[:, vy // dh, vx // dw]
    return cols.reshape(n, ho, wo, kh * kw * cp)


@pytest.mark.parametrize("name", PACKING)
def test_packing_replays_as_im2col(name):
    """`pack_weight`'s rows (taps in (ky, kx) order, channels padded to 32,
    rows padded to 64) against the im2col the kernel gathers: the int32
    sums and the dequantized outputs equal `qconv_reference`'s."""
    ci, co, (kh, kw), (sh, sw), (ph, pw), (dh, dw), (h, w) = PACKING[name]
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(2, ci, h, w).astype(np.float32))
    wq = torch.from_numpy(rs.randint(-127, 128, (co, ci, kh, kw))
                          .astype(np.int8))
    cp = qconv.padded_channels(ci)
    wp = qconv.pack_weight(wq, cp)
    assert wp.shape == (-(-co // 64) * 64, kh * kw * cp)
    assert not wp[co:].any()
    ho = qconv.conv_out_size(h, kh, sh, ph, ph, dh)
    wo = qconv.conv_out_size(w, kw, sw, pw, pw, dw)
    geometry = [kh, kw, sh, sw, ph, pw, dh, dw, ho, wo]
    xq, sx = qconv.quant_act(x, cp)
    sw_ = torch.from_numpy(rs.uniform(0.001, 0.01, co).astype(np.float32))
    acc = im2col_replay(xq.numpy(), geometry) @ wp.numpy().astype(
        np.int64).T
    acc = torch.from_numpy(acc[..., :co]).permute(0, 3, 1, 2)
    want = qconv.qconv_reference(xq, wp, sx, sw_, None, geometry,
                                 torch.float32)
    got = acc.to(torch.float32) * (sx[:, None, None, None]
                                   * sw_[None, :, None, None])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the dilated geometry is the transposed conv's: torch's own op agrees
    if dh > 1:
        wt = qconv.unpack_weight(wp, co, kh, kw).double().flip(2, 3)
        ref = torch.nn.functional.conv_transpose2d(
            xq.permute(0, 3, 1, 2).double(), wt.transpose(0, 1), stride=dh,
            padding=kh - 1 - ph)
        torch.testing.assert_close(acc.double(), ref, rtol=0, atol=0)


@pytest.mark.parametrize("op", ["quant_act", "qconv_int8"])
def test_custom_ops_pass_opcheck(op):
    """Schema, fake implementation and dispatch of the two custom ops
    (`torch.library.opcheck`), as `torch.export` needs them."""
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(2, 18, 5, 6).astype(np.float32))
    if op == "quant_act":
        args = (x, 32)
    else:
        xq, sx = qconv.quant_act(x, 32)
        wq = torch.from_numpy(rs.randint(-127, 128, (18, 18, 3, 3))
                              .astype(np.int8))
        args = (xq, qconv.pack_weight(wq, 32), sx,
                torch.full((18,), 0.01), torch.full((18,), 0.5),
                [3, 3, 2, 2, 1, 1, 1, 1, 3, 3], torch.bfloat16)
    torch.library.opcheck(getattr(torch.ops.msml_torch, op).default, args)


def test_fma_f32_rounds_once():
    """The plain version's float32 FMA (the bias of a float32 output)
    against exact rational arithmetic, on random triples and on triples
    whose float64 sum lands on a midpoint of the float32 grid."""
    from fractions import Fraction

    def exact(a, b, c):
        r = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
        y = np.float32(float(r))
        cands = [y, np.nextafter(y, np.float32(np.inf)),
                 np.nextafter(y, np.float32(-np.inf))]
        dist = [abs(Fraction(float(v)) - r) for v in cands]
        best = min(dist)
        ties = [v for v, d in zip(cands, dist) if d == best]
        return min(ties, key=lambda v: int(v.view(np.uint32)) & 1)

    rs = np.random.RandomState(7)
    a = rs.randn(2000).astype(np.float32)
    b = rs.randn(2000).astype(np.float32)
    c = rs.randn(2000).astype(np.float32)
    # y + (u / 2) (1 - 2^-46), u = the ulp of y: a sum that rounds to the
    # float32 midpoint y + u / 2 in float64, though it lies below it
    y = rs.uniform(1, 2, 2000).astype(np.float32) * np.sign(rs.randn(2000)) \
        .astype(np.float32)
    u = np.abs(np.nextafter(y, y * 2) - y)
    eps = np.float32(2.0 ** -23)
    a = np.concatenate([a, (u / 2) * (1 + eps) * np.sign(y)])
    b = np.concatenate([b, np.full(2000, 1 - eps, np.float32)])
    c = np.concatenate([c, y])
    p = a.astype(np.float64) * b
    got = qconv.fma_f32(*map(torch.from_numpy, (a, b, c))).numpy()
    want = np.array([exact(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    naive = (p + c).astype(np.float32)
    assert (naive != want).any()  # the case the correction is for


def test_quant_act_rounds_half_to_even_and_clips():
    """Ties go to even codes (jnp.round), |code| <= 127, zero rows stay
    zero with the scale's floor, and the fc's (N, C) input keeps its
    layout."""
    sx = qconv.act_scale_reference(torch.tensor([[127.0, 1.0]]))
    assert sx.item() == np.float32(127.0) * np.float32(1 / 127)
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.0, 0.0]]) \
        * sx.item()
    xq, got = qconv.quant_act_reference(x, 32)
    assert xq.shape == (1, 1, 1, 32) and got.item() == sx.item()
    np.testing.assert_array_equal(
        xq[0, 0, 0, :8].numpy(),
        np.round(x[0].numpy() / sx.item()).clip(-127, 127))
    zq, zs = qconv.quant_act_reference(torch.zeros(2, 3, 4, 4), 32)
    assert not zq.any() and (zs == np.float32(qconv.EPS)).all()


# ----------------------------------------- skip rules, JAX's small CNN

class _SmallCNN(fnn.Module):
    """`tests/test_quantize.py::_SmallCNN`."""

    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(64, (3, 3), padding="SAME", use_bias=False)(x)
        x = fnn.relu(x)
        x = fnn.Conv(64, (3, 3), padding="SAME", use_bias=False)(x)
        x = fnn.relu(x)
        x = x.mean(axis=(1, 2))
        return fnn.Dense(32, use_bias=False)(x)


class SmallCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv2d(3, 64, 3, padding=1, bias=False)
        self.c2 = nn.Conv2d(64, 64, 3, padding=1, bias=False)
        self.fc = nn.Linear(64, 32, bias=False)

    def forward(self, x):
        x = torch.relu(self.c2(torch.relu(self.c1(x))))
        return self.fc(x.mean((2, 3)))


@pytest.fixture(scope="module")
def small():
    jm = _SmallCNN()
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)))
    p = jax.device_get(v["params"])
    tm = SmallCNN()
    with torch.no_grad():
        for mod, key in ((tm.c1, "Conv_0"), (tm.c2, "Conv_1")):
            mod.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                p[key]["kernel"].transpose(3, 2, 0, 1))))
        tm.fc.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            p["Dense_0"]["kernel"].T)))
    return (lambda img: jm.apply(v, img)), tm


def rand(b=4, seed=0):
    return np.random.RandomState(seed).randn(b, 16, 16, 3).astype(np.float32)


@pytest.mark.parametrize("kw", [
    {}, {"min_contract": 1024}, {"quantize_dot": False},
    {"min_contract": 576}, {"min_contract": 577}], ids=str)
def test_small_cnn_stats_equal_jax(small, kw):
    """JAX's `stats_out` for the default rules, the `min_contract` gate
    (on both sides of the C = 64 conv's 576) and the `quantize_dot`
    toggle; the outputs agree to float32 summation order."""
    jfwd, tm = small
    x = rand()
    jstats, tstats = {}, {}
    want = np.asarray(jax.jit(jquant.quantize_fn(
        jfwd, stats_out=jstats, **kw))(x))
    tkw = dict(kw)
    if "quantize_dot" in tkw:
        tkw["quantize_linear"] = tkw.pop("quantize_dot")
    qm = quantize_model(tm, nchw(x), stats_out=tstats, **tkw)
    assert tstats == jstats
    with torch.no_grad():
        got = qm(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert len(quant_sites(qm)) == (tstats["conv_quantized"]
                                    + tstats["dot_quantized"])


def test_model_is_not_changed(small):
    _, tm = small
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    qm = quantize_model(tm, nchw(rand()))
    assert all(type(m) in (SmallCNN, nn.Conv2d, nn.Linear)
               for m in tm.modules())
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())
    assert set(qm.state_dict()) == {"c1.weight", "c2.wp", "c2.sw", "fc.wp",
                                    "fc.sw"}
    assert qm.c2.wp.dtype == torch.int8


def test_zero_input_finite(small):
    """All-zero rows (the batcher's padding) give finite outputs through
    the dynamic scale's floor."""
    _, tm = small
    zero = torch.zeros(2, 3, 16, 16)
    with torch.no_grad():
        assert torch.isfinite(quantize_model(tm, zero)(zero)).all()


def test_batch_invariance_per_sample_scales(small):
    """`tests/test_quantize.py`'s case: a row's output does not depend on
    its batch-mates, bit for bit (at one batch size: the float stem conv
    kept in float32 may sum in another order at another one)."""
    _, tm = small
    x = nchw(rand(4, seed=2))
    qm = quantize_model(tm, x)
    with torch.no_grad():
        big = qm(torch.cat([x, 100.0 * torch.ones_like(x)]))
        alone = qm(torch.cat([x, torch.zeros_like(x)]))
    torch.testing.assert_close(big[:4], alone[:4], rtol=0, atol=0)


def test_integer_op_stays_untouched():
    """An integer linear is not a float op: kept and counted as JAX counts
    its integer dot."""
    lin = nn.Linear(128, 8, bias=False)
    lin.weight = nn.Parameter(torch.ones(8, 128, dtype=torch.int64),
                              requires_grad=False)
    x = torch.ones(4, 128, dtype=torch.int64)
    stats = {}
    qm = quantize_model(lin, x, stats_out=stats)
    assert stats == {"conv_quantized": 0, "conv_kept": 0,
                     "dot_quantized": 0, "dot_kept": 1}
    assert type(qm) is nn.Linear
    assert (qm(x) == 128).all()


def test_bf16_graph_quantizes_and_returns_bf16():
    """JAX's case: a bf16 dot is quantized and gives bf16; the port's
    linear under the bf16 autocast, with the same codes and output."""
    x = rand(2, seed=3).reshape(2, -1)
    w = np.random.RandomState(4).randn(x.shape[1], 8).astype(np.float32)

    def fwd(x, w):
        return lax.dot(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16))

    stats, tstats = {}, {}
    want = jax.jit(jquant.quantize_fn(fwd, stats_out=stats))(x, w)
    lin = nn.Linear(x.shape[1], 8, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
    qm = quantize_model(Autocast(lin, torch.bfloat16), torch.from_numpy(x),
                        stats_out=tstats)
    assert stats["dot_quantized"] == tstats["dot_quantized"] == 1
    with torch.no_grad():
        got = qm(torch.from_numpy(x))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), as_f32(want))


def test_ops_the_kernel_does_not_take_are_kept():
    """Grouped and dilated convs (none in the zoo) stay in float, counted
    as kept; a rank-3 linear input, as JAX keeps a batched dot."""
    m = nn.Sequential(nn.Conv2d(64, 64, 3, padding=1, groups=2),
                      nn.Conv2d(64, 64, 3, padding=2, dilation=2))
    stats = {}
    quantize_model(m, torch.randn(1, 64, 6, 6), stats_out=stats)
    assert stats["conv_kept"] == 2 and stats["conv_quantized"] == 0
    quantize_model(nn.Linear(64, 8), torch.randn(2, 3, 64), stats_out=stats)
    assert stats["dot_kept"] == 1


# ------------------------------------ arc18_msml at one block per stage

@pytest.fixture(scope="module")
def msml():
    """The same numpy-drawn weights in both packages (float32), JAX's
    jitted quantized eval forward with its counts, the port's float model
    and its quantized copy, and their features on B = 2 images."""
    from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
    from msml_tpu.nn.iresnet import IRESNET_LAYERS as JAX_LAYERS
    from msml_tpu.nn.msml import msml_from_config as jax_msml
    from msml_torch.core.precision import FULL_PRECISION
    from msml_torch.nn.iresnet import IRESNET_LAYERS
    from msml_torch.nn.msml import msml_from_config
    from msml_torch.tools.convert import state_dict_from_jax
    from tests.test_torch_export_weights import jax_trees
    from tests.test_torch_nn import arc18_configs

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JAX_LAYERS, "iresnet18", (1, 1, 1, 1))
        mp.setitem(IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        params, stats = jax_trees(seed=4)
        jcfg, tcfg = arc18_configs()
        jmodel = jax_msml(jcfg, policy=JAX_F32, external_header=True)
        params = {k: v for k, v in params.items() if k != "classification"}
        variables = {"params": params, "batch_stats": stats}
        jstats = {}

        def features(x):
            return jmodel.apply(variables, x, train=False)[0]

        jfwd = jax.jit(jquant.quantize_fn(features, stats_out=jstats))
        x = np.random.RandomState(5).uniform(-1, 1, (2, 112, 112, 3)) \
            .astype(np.float32)
        want = np.asarray(jfwd(x))
        model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu")
        model.load_state_dict(state_dict_from_jax(params, stats))
        tstats = {}
        xt = nchw(x)
        qmodel = quantize_model(model, xt[:1], stats_out=tstats)
        with torch.no_grad():
            got = qmodel(xt)[0].numpy()
            flt = model(xt)[0].numpy()
    return dict(jstats=jstats, tstats=tstats, want=want, got=got, flt=flt,
                model=model, qmodel=qmodel, features=features, x=x)


def cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.sum(a * b, 1) / np.linalg.norm(a, axis=1)
            / np.linalg.norm(b, axis=1))


def min_cos(a, b):
    return cos_rows(a, b).min()


def test_msml_stats_equal_jax(msml):
    """The same decisions op by op count as JAX's on the flagship graph:
    every conv of the OSB, the FM operators and the FRB, kept where the
    contraction is under 64 (the two stems, gcm1's 8-channel convs, the
    stage-1 FM bottlenecks' 32 -> 64), and the fc."""
    assert msml["tstats"] == msml["jstats"]
    assert msml["tstats"]["dot_quantized"] == 1
    assert msml["tstats"]["conv_kept"] == 6
    sites = quant_sites(msml["qmodel"])
    assert "frb.fc" in sites and "osb.deconv2" in sites
    assert len(sites) == msml["tstats"]["conv_quantized"] + 1


def test_msml_quantized_features_match_jax(msml):
    """Within JAX's bound, and for each image nearer JAX's int8 features
    than the port's float features are: the end-to-end gap is that of
    code flips, not of a missing quantization."""
    assert min_cos(msml["got"], msml["want"]) >= JAX_MIN_COS
    assert (cos_rows(msml["got"], msml["want"])
            > cos_rows(msml["flt"], msml["want"])).all()


@pytest.fixture(scope="module")
def jax_sites(msml):
    """What each int8 op of JAX's jitted quantized forward saw and made, on
    the fixture's images: {site: (kind, dimension numbers, x, w, xq, sx,
    y)}, recorded by `jax.debug.callback` from wrappers of `_q_conv` /
    `_q_dot` (y before the bias, which JAX adds in an op of its own)."""
    seen = {}

    def recorder(orig, kind):
        def q(eqn, invals, min_contract):
            out = orig(eqn, invals, min_contract)
            if out is not None:
                x, w = invals
                dn = eqn.params["dimension_numbers"]
                batch_axis = dn.lhs_spec[0] if kind == "conv" else 0
                xq, sx = jquant._quant_act(x, batch_axis=batch_axis)
                site = len(seen)
                seen[site] = None

                def record(*vals, site=site, dn=dn):
                    seen[site] = (kind, dn) + tuple(np.asarray(v)
                                                    for v in vals)
                jax.debug.callback(record, x, w, xq, sx, out)
            return out
        return q

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquant, "_q_conv", recorder(jquant._q_conv, "conv"))
        mp.setattr(jquant, "_q_dot", recorder(jquant._q_dot, "dot"))
        jax.block_until_ready(jax.jit(jquant.quantize_fn(msml["features"]))(
            msml["x"]))
        jax.effects_barrier()
    return seen


def test_msml_every_site_equals_jax_on_its_activations(msml, jax_sites):
    """Each of the port's int8 sites, fed the activations that JAX's
    equation saw, makes JAX's codes, scales and outputs bit for bit: the
    sites are found by their float weights (the same values in another
    layout), the fc's features reordered from JAX's HWC flatten to the
    port's CHW one."""
    model, qmodel = msml["model"], msml["qmodel"]
    by_weight = {np.sort(m.weight.detach().numpy().ravel()).tobytes(): name
                 for name, m in model.named_modules()
                 if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d,
                                   nn.Linear))}
    names = set()
    for site, (kind, dn, x, w, xq, sx, y) in jax_sites.items():
        name = by_weight[np.sort(w.ravel()).tobytes()]
        names.add(name)
        m = qmodel.get_submodule(name)
        assert isinstance(m, QuantConv), name
        if kind == "conv":
            x = np.transpose(x, dn.lhs_spec)  # NCHW
            xq = np.transpose(xq, (dn.lhs_spec[0], *dn.lhs_spec[2:],
                                   dn.lhs_spec[1]))  # NHWC
            y = np.transpose(y, dn.out_spec)
        else:  # the fc: (B, H * W * C) -> (B, C * H * W)
            c = x.shape[1] // 49
            x, xq = (v.reshape(-1, 7, 7, c).transpose(0, 3, 1, 2)
                     .reshape(v.shape[0], 1, 1, -1) for v in (x, xq))
            x = x[:, 0, 0]
        tq, tsx = qconv.quant_act(torch.tensor(x), m.cp)
        np.testing.assert_array_equal(tq[..., :xq.shape[-1]].numpy(), xq,
                                      err_msg=name)
        np.testing.assert_array_equal(tsx.numpy(), sx, err_msg=name)
        h, wd = (1, 1) if x.ndim == 2 else x.shape[2:]
        got = qconv.qconv_int8(tq, m.wp, tsx, m.sw, None, m.geometry(h, wd),
                               m.dtype)
        np.testing.assert_array_equal(
            got.flatten(1).numpy() if kind == "dot" else got.numpy(), y,
            err_msg=name)
    assert len(names) == len(jax_sites) == len(quant_sites(qmodel)) \
        == msml["jstats"]["conv_quantized"] + msml["jstats"]["dot_quantized"]


def test_msml_quantized_close_to_float(msml):
    assert np.isfinite(msml["got"]).all()
    assert min_cos(msml["got"], msml["flt"]) >= FLOAT_MIN_COS


def test_make_quantized_eval_step(msml):
    """train_step's counterpart: NHWC numpy in, the quantized features
    out, the model untouched; modes other than int8 refused with JAX's
    message."""
    from msml_torch.train.train_step import make_quantized_eval_step

    with pytest.raises(ValueError, match="unknown quant mode 'int4'"):
        make_quantized_eval_step(msml["model"], (112, 112, 3),
                                 quant="int4")
    x = np.random.RandomState(5).uniform(-1, 1, (2, 112, 112, 3)) \
        .astype(np.float32)
    step = make_quantized_eval_step(msml["model"], (112, 112, 3))
    np.testing.assert_array_equal(step(x), msml["got"])
    assert not quant_sites(msml["model"])


# ------------------ the LightCNN gray recipe (configs/lightcnn_msml.yaml)

def test_lightcnn_msml_stats_equal_jax():
    """The recipe at full width and depth, 128 x 128 x 1: the port's four
    counts equal `quantize_fn`'s, kept where the contraction is under 64
    (LightCNN's 5x5 conv1 on one channel, 25; the OSB's stem, 9; stage
    1's group conv_a, 48; the narrow FMs' 1x1 bottleneck convs; gcm1's
    8-channel convs); every mfm conv and the fc otherwise int8, and the
    int8 features of one image within JAX's bound of JAX's."""
    from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
    from msml_tpu.nn.msml import msml_from_config as jax_msml
    from msml_torch.core.precision import FULL_PRECISION
    from msml_torch.nn.msml import msml_from_config
    from msml_torch.tools.convert import state_dict_from_jax
    from tests.test_torch_lightcnn_msml import recipe_configs
    from tests.test_torch_nn import random_variables

    jcfg, tcfg = recipe_configs()
    jmodel = jax_msml(jcfg, policy=JAX_F32, external_header=True)
    x = np.random.RandomState(5).uniform(0, 1, (1, 128, 128, 1)) \
        .astype(np.float32)
    variables = random_variables(jmodel, x, train=False, seed=6)
    jstats, tstats = {}, {}

    def features(img):
        return jmodel.apply(variables, img, train=False)[0]

    want = np.asarray(jax.jit(jquant.quantize_fn(features,
                                                 stats_out=jstats))(x))
    model = msml_from_config(tcfg, policy=FULL_PRECISION, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"])), strict=True)
    qmodel = quantize_model(model, nchw(x), stats_out=tstats)
    assert tstats == jstats
    sites = quant_sites(qmodel)
    assert len(sites) == tstats["conv_quantized"] + tstats["dot_quantized"]
    assert tstats["dot_quantized"] == 1 and "frb.fc" in sites
    for kept in ("frb.conv1.filter", "osb.conv1", "frb.group1.conv_a.filter"):
        assert kept not in sites, kept
    for quantized in ("frb.group1.conv.filter", "frb.block4.3.conv2.filter",
                      "frb.group4.conv_a.filter", "osb.deconv5"):
        assert quantized in sites, quantized
    with torch.no_grad():
        got = qmodel(nchw(x))[0].numpy()
    assert min_cos(got, want) >= JAX_MIN_COS


# ------------------------------------------- the entry points, --quant int8

PAIRS = 4  # the plain int8 convs sum in float64 on the CPU: ~1 s an image


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A weight folder as `cli.train` leaves it (config.yaml at fp16: false,
    ckpt/3.pt) of numpy-drawn weights at one block per stage, their JAX
    variables, and a 4-pair PPM .bin. The layers stay cut for the
    module's tests, which build the model from the folder."""
    import chip_smoke
    from msml_tpu.nn.iresnet import IRESNET_LAYERS as JAX_LAYERS
    from msml_torch.core.config import save_yaml
    from msml_torch.data.bin_loader import ppm_encode
    from msml_torch.nn.iresnet import IRESNET_LAYERS
    from msml_torch.tools.convert import state_dict_from_jax
    from tests.test_torch_export_weights import CLASSES, jax_trees
    from tests.test_torch_host_sweep import write_bin

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JAX_LAYERS, "iresnet18", (1, 1, 1, 1))
        mp.setitem(IRESNET_LAYERS, "iresnet18", (1, 1, 1, 1))
        out = tmp_path_factory.mktemp("qfolder")
        params, stats = jax_trees(seed=2)
        save_yaml(dict(chip_smoke.ARC18_MSML, dataset="synthetic",
                       num_classes=CLASSES, fp16=False),
                  str(out / "config.yaml"))
        os.makedirs(out / "ckpt")
        torch.save({"model": state_dict_from_jax(params, stats), "step": 3},
                   str(out / "ckpt" / "3.pt"))
        bin_path = write_bin(str(out / "pairs.bin"), ppm_encode,
                             pairs=PAIRS)
        yield dict(path=str(out), params=params, stats=stats, bin=bin_path)


def test_serve_weight_folder_quantized(folder):
    """`cli.serve`'s folder runner with quant="int8": "quant" in its meta
    and /healthz, the int8 kernels in its forward, its HTTP answers equal
    to the in-process forward, near the float runner's."""
    from msml_torch.cli import serve
    from tests.test_torch_serve import _get, _post, npy, serving

    runner = serve.runner_from_weight_folder(folder["path"], "cpu",
                                             quant="int8")
    assert runner.meta["quant"] == "int8"
    flt = serve.runner_from_weight_folder(folder["path"], "cpu")
    assert "quant" not in flt.meta
    x = np.random.RandomState(8).uniform(-1, 1, (3, 112, 112, 3)) \
        .astype(np.float32)
    want = runner.infer(x)
    with serving(serve, runner, max_batch=4) as base:
        assert _get(base + "/healthz")[1]["quant"] == "int8"
        code, out = _post(base + "/embed_batch", npy(x))
    assert code == 200
    np.testing.assert_array_equal(np.asarray(out["embeddings"], np.float32),
                                  want)
    assert min_cos(want, flt.infer(x)) >= FLOAT_MIN_COS
    with pytest.raises(ValueError, match="unknown quant mode"):
        serve.runner_from_weight_folder(folder["path"], "cpu", quant="int4")


def test_serve_refuses_quant_for_an_artifact():
    """JAX's refusal and message: an artifact is quantized at export."""
    from msml_torch.cli import serve

    with pytest.raises(SystemExit, match="export_serving --quant int8"):
        serve.main(serve.parse_args(["--artifact", "m.pt2", "--quant",
                                     "int8", "--device", "cpu"]))


def test_export_serving_quantized(folder, tmp_path):
    """`tools.export_serving --quant int8`: int8 weight constants and the
    two custom ops in the graph (none of the float kernels' conv3x3 sites
    left), under a quarter of the bytes of the float weights that a float
    artifact holds, `"quant": "int8"` in the sidecar; loaded, it gives the
    quantized module's features, and `cli.serve --artifact` serves it."""
    from msml_torch.cli import serve
    from msml_torch.core.quantize import quantize_model
    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.tools import export_serving
    from msml_torch.tools.export_serving import EvalForward
    from tests.test_torch_export_serving import graph_nodes

    def export(out, *extra):
        return export_serving.main(export_serving.parse_args(
            ["--weight_folder", folder["path"], "--out", out, "--device",
             "cpu", *extra]))

    qnt = str(tmp_path / "int8.pt2")
    program = export(qnt, "--quant", "int8")
    with open(qnt + ".json") as f:
        assert json.load(f)["quant"] == "int8"
    targets = [str(n.target) for n in graph_nodes(program)]
    _, model = load_weight_folder(folder["path"], device="cpu")
    float_bytes = sum(t.numel() * t.element_size()
                      for t in model.state_dict().values())
    assert os.path.getsize(qnt) * 3.5 < float_bytes
    qmodel = quantize_model(EvalForward(model), torch.zeros(1, 112, 112, 3))
    sites = len(quant_sites(qmodel))
    assert targets.count("msml_torch.qconv_int8.default") == sites
    assert targets.count("msml_torch.quant_act.default") == sites
    assert "msml_torch.conv3x3_fwd.default" not in targets
    x = np.random.RandomState(9).uniform(-1, 1, (3, 112, 112, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        want = qmodel(torch.from_numpy(x)).numpy()
    got = torch.export.load(qnt).module()(torch.from_numpy(x))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    runner = serve.runner_from_artifact(qnt, "cpu", flip=False,
                                        l2_norm=False)
    assert runner.meta["quant"] == "int8"
    np.testing.assert_array_equal(runner.infer(x), want)


def test_cli_test_host_sweep_quantized_matches_jax(folder, tmp_path,
                                                   monkeypatch):
    """`cli.test --quant int8` on the host sweep (`--no-occ`) against JAX's
    sweep with its jitted `quantize_fn` forward on the same weights: the
    saved features by cosine (`JAX_MIN_COS`), the rows within one pair."""
    from msml_tpu.core.precision import FULL_PRECISION as JAX_F32
    from msml_tpu.eval.occ_sweep import occlusion_sweep as jax_sweep
    from msml_tpu.nn.iresnet import IRESNET_LAYERS as JAX_LAYERS
    from msml_tpu.nn.msml import msml_from_config as jax_msml
    from msml_torch.cli import test as cli_test
    from msml_torch.data.bin_loader import load_bin_pil
    from tests.test_torch_host_sweep import fast_evaluate
    from tests.test_torch_nn import arc18_configs

    fast_evaluate.__wrapped__(monkeypatch)
    monkeypatch.setitem(JAX_LAYERS, "iresnet18", (1, 1, 1, 1))
    jcfg, _ = arc18_configs()
    jmodel = jax_msml(jcfg, policy=JAX_F32, external_header=True)
    params = {k: v for k, v in folder["params"].items()
              if k != "classification"}
    variables = {"params": params, "batch_stats": folder["stats"]}
    fwd = jax.jit(jquant.quantize_fn(
        lambda x: jmodel.apply(variables, x, train=False)[0]))
    kw = ["--no-occ", "--batch-size", str(2 * PAIRS)]
    got = cli_test.main(cli_test.parse_args(
        ["--weight_folder", folder["path"], "--bin", folder["bin"],
         "--quant", "int8", "--device", "cpu", "--save-features",
         str(tmp_path / "port"), *kw]))
    imgs, issame = load_bin_pil(folder["bin"])
    want = jax_sweep(imgs, issame, lambda x: np.asarray(fwd(x)),
                     feature_dir=str(tmp_path / "jax"), no_occ=True,
                     batch_size=2 * PAIRS, verbose=False)
    names = os.listdir(tmp_path / "jax")
    assert sorted(names) == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        a, b = (np.load(tmp_path / d / name) for d in ("port", "jax"))
        assert min_cos(a.reshape(len(a), -1), b.reshape(len(b), -1)) \
            >= JAX_MIN_COS, name
    for g, w in zip(got, want):
        assert g["lo"] == w["lo"]
        assert abs(g["avg_acc"] - w["avg_acc"]) <= 1.0 / PAIRS, (g, w)


def test_cli_test_device_sweep_quantized(folder, monkeypatch):
    """`cli.test --device-sweep --quant int8` runs the int8 kernels' plain
    versions on the CPU and gives the rows of `occlusion_sweep_device` on
    the quantized model."""
    from msml_torch.cli import test as cli_test
    from msml_torch.core.weight_folder import load_weight_folder
    from msml_torch.data.bin_loader import load_bin
    from msml_torch.eval.occ_sweep_device import occlusion_sweep_device
    from tests.test_torch_host_sweep import fast_evaluate

    fast_evaluate.__wrapped__(monkeypatch)
    calls = []
    real = qconv.qconv_int8
    monkeypatch.setattr(qconv, "qconv_int8",
                        lambda *a: calls.append(1) or real(*a))
    rows = cli_test.main(cli_test.parse_args(
        ["--device-sweep", "--weight_folder", folder["path"], "--bin",
         folder["bin"], "--quant", "int8", "--no-occ", "--device", "cpu"]))
    assert calls
    _, model = load_weight_folder(folder["path"], device="cpu")
    qmodel = quantize_model(model, torch.zeros(1, 3, 112, 112))
    data, issame = load_bin(folder["bin"], (112, 112))
    with torch.inference_mode():
        want = occlusion_sweep_device(
            data, issame, lambda img: qmodel(img)[0], no_occ=True,
            verbose=False, device="cpu")
    assert rows == want
