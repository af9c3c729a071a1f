"""The port's C = 64 3x3 conv (msml_torch.kernels.conv3x3) against the TPU
kernels it replaces and against JAX's own convolution, on the CPU.

The TPU kernels are `benchmarks/negative/conv_gemm.py`'s `_fwd_kernel` (via
`conv3x3_gemm`, also dX on `flip_weights`) and `_dw_kernel` (via
`conv3x3_gemm_dw`), run in interpret mode as
benchmarks/negative/test_conv_gemm.py runs them; the port's wrappers run
their plain versions here (CPU tensors). Inputs are numpy draws from a
seed, NHWC / HWIO on the JAX side and NCHW / OIHW on the port's. The
weights are scaled by 1 / sqrt(9 Ci) and dY by 1 / sqrt(N H W / 64), so
that outputs and dW are of order one and the tolerances of
test_conv_gemm.py hold for float32 sums in another order: forward and dX
atol 2e-5, dW atol 1e-4.

The card's kernels are held against the same plain versions in
tests/test_torch_cuda.py and chip_smoke.py. The tiling tests below replay
the kernels' index arithmetic (csrc/conv3x3.cu) in numpy.
"""

import importlib.util
import math
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from msml_torch.kernels import _nvcc
from msml_torch.kernels.conv3x3 import (DW_BLOCKS, DW_MAX_CHUNKS, DW_PAD,
                                        DW_STRIP, DW_TILE, FWD_WARPS,
                                        MAX_SMEM, MAX_WIDTH, WS, X_SLOTS,
                                        conv3x3, conv3x3_dw,
                                        conv3x3_dw_reference, conv3x3_fwd,
                                        conv3x3_reference, dw_geometry,
                                        dw_row_stride, dw_rows_geometry,
                                        dw_smem_bytes, dw_vector,
                                        flip_weights, fwd_smem_bytes)
from msml_torch.nn.common import Conv3x3, routed_conv_sites

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, H, W, C, bt, rows): bt packs the batch into lanes, rows divides H
SHAPES = [(4, 8, 8, 4, 2, 4), (2, 14, 14, 64, 2, 7), (2, 28, 28, 64, 2, 28),
          (2, 6, 7, 8, 2, 3)]
IDS = ["b4_8x8_c4", "b2_14x14_c64", "b2_28x28_c64", "b2_6x7_c8"]


def _conv_gemm():
    path = os.path.join(REPO, "benchmarks", "negative", "conv_gemm.py")
    spec = importlib.util.spec_from_file_location("conv_gemm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CG = _conv_gemm()


def _data(shape, seed=0):
    b, h, w, c = shape[:4]
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    wt = (rng.randn(3, 3, c, c) / math.sqrt(9 * c)).astype(np.float32)
    dy = (rng.randn(b, h, w, c) / math.sqrt(b * h * w / 64)).astype(
        np.float32)
    return x, wt, dy


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def _lax(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_forward_matches_pallas_and_lax(shape):
    x, w, _ = _data(shape, 0)
    bt, rows = shape[4:]
    got = nhwc(conv3x3_fwd(nchw(x), oihw(w)))
    pallas = CG.conv3x3_gemm(jnp.asarray(x), jnp.asarray(w), bt=bt,
                             rows=rows, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(_lax(x, w)), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_dx_matches_pallas_flipped_and_vjp(shape):
    x, w, dy = _data(shape, 1)
    bt, rows = shape[4:]
    flipped = flip_weights(oihw(w)).contiguous()
    np.testing.assert_array_equal(
        flipped.numpy(), oihw(np.asarray(CG.flip_weights(w))).numpy())
    got = nhwc(conv3x3_fwd(nchw(dy), flipped))
    pallas = CG.conv3x3_gemm(jnp.asarray(dy), CG.flip_weights(jnp.asarray(w)),
                             bt=bt, rows=rows, interpret=True)
    _, vjp = jax.vjp(lambda xx: _lax(xx, w), jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(dy))[0]),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_dw_matches_pallas_and_vjp(shape):
    x, w, dy = _data(shape, 2)
    bt, rows = shape[4:]
    got = conv3x3_dw(nchw(x), nchw(dy)).numpy().transpose(2, 3, 1, 0)
    pallas = CG.conv3x3_gemm_dw(jnp.asarray(x), jnp.asarray(dy), bt=bt,
                                rows=rows, interpret=True)
    _, vjp = jax.vjp(lambda ww: _lax(x, ww), jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(dy))[0]),
                               atol=1e-4, rtol=0)


def test_function_gradients_equal_conv2d():
    """The autograd Function against F.conv2d's own gradients, float32."""
    x, w, dy = _data((3, 9, 11, 16), 3)
    tx, tw = nchw(x), oihw(w)
    grads = []
    for fn in (conv3x3, lambda a, b: F.conv2d(a, b, padding=1)):
        a, b = tx.clone().requires_grad_(), tw.clone().requires_grad_()
        y = fn(a, b)
        y.backward(nchw(dy))
        grads.append((y.detach(), a.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_gradcheck_float64():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 3, 5, 4), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn((2, 3, 3, 3), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(conv3x3, (x, w))


def test_cpu_wrappers_are_the_plain_versions():
    """On a CPU tensor the wrappers return the plain versions and launch
    nothing; the plain forward keeps x's dtype and sums in f32."""
    x, w, dy = _data((2, 6, 5, 64), 5)
    tx, tw, tdy = nchw(x), oihw(w), nchw(dy)
    f0, d0 = conv3x3_fwd.launches, conv3x3_dw.launches
    assert torch.equal(conv3x3_fwd(tx, tw), conv3x3_reference(tx, tw))
    assert torch.equal(conv3x3_dw(tx, tdy), conv3x3_dw_reference(tx, tdy))
    assert (conv3x3_fwd.launches, conv3x3_dw.launches) == (f0, d0)
    xb, wb = tx.bfloat16(), tw.bfloat16()
    yb = conv3x3_fwd(xb, wb)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, conv3x3_reference(xb.float(), wb.float())
                       .bfloat16())
    assert conv3x3_dw(xb, tdy.bfloat16()).dtype == torch.float32


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros((1, 64, 4, 4))
    with pytest.raises(ValueError, match="shapes"):
        conv3x3_fwd(x, torch.zeros((64, 32, 3, 3)))
    with pytest.raises(ValueError, match="dtypes"):
        conv3x3_fwd(x, torch.zeros((64, 64, 3, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_fwd(x.to("meta"), torch.zeros((64, 64, 3, 3), device="meta"))


ARC18_SITES = ["frb.layer1.0.conv1", "frb.layer1.1.conv1",
               "frb.layer1.1.conv2", "frb.fm_ops.1.res_block.0.conv2",
               "frb.fm_ops.1.res_block.1.conv2", "osb.layer1.0.conv1",
               "osb.layer1.1.conv1", "osb.layer1.1.conv2"]


def test_routed_sites_of_arc18_msml():
    """Exactly the 8 convs that are 64 -> 64, 3x3, stride 1, no bias; the
    FM convs at C = 64 are fm_ops.1's (its bottleneck is 128 // 2)."""
    import chip_smoke
    from msml_torch.core.config import Config, config_init
    from msml_torch.nn.msml import msml_from_config

    cfg = config_init(Config.from_dict(chip_smoke.ARC18_MSML),
                      make_output_dir=False)
    model = msml_from_config(cfg, device="cpu", head=True)
    assert routed_conv_sites(model) == ARC18_SITES
    n_conv = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    seen = []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d) and m.in_channels == 64 \
                and m.out_channels == 64 and m.kernel_size == (3, 3) \
                and m.stride == (1, 1) and m.bias is None:
            seen.append(name)
    assert seen == ARC18_SITES and n_conv > len(seen)


@pytest.mark.parametrize("cin,cout,stride,bias,routed", [
    (64, 64, 1, False, True), (64, 64, 2, False, False),
    (32, 32, 1, False, False), (64, 64, 1, True, False),
    (64, 128, 1, False, False)])
def test_conv3x3_module_routes_only_the_kernel_shape(cin, cout, stride,
                                                     bias, routed):
    """Routed or not, the module computes F.conv2d's function, keeps its
    parameter names, and loads a plain nn.Conv2d's state dict."""
    torch.manual_seed(6)
    plain = torch.nn.Conv2d(cin, cout, 3, stride, 1, bias=bias)
    conv = Conv3x3(cin, cout, stride, bias)
    conv.load_state_dict(plain.state_dict(), strict=True)
    assert conv.routed == routed
    x = torch.randn((2, cin, 9, 10))
    torch.testing.assert_close(conv(x), plain(x), atol=1e-5, rtol=1e-5)


def test_routed_module_under_cpu_autocast():
    """Under bf16 autocast the routed module casts x and the weight as
    F.conv2d's autocast would: a bf16 output, an f32 weight gradient, both
    within bf16 rounding of F.conv2d under the same autocast (relative L2
    error <= 1e-2)."""
    torch.manual_seed(7)
    conv = Conv3x3(64, 64)
    x = torch.randn((2, 64, 12, 12))
    outs = []
    for fn in (conv, lambda v: F.conv2d(v, conv.weight, padding=1)):
        conv.weight.grad = None
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = fn(x)
        assert y.dtype == torch.bfloat16
        y.float().square().sum().backward()
        outs.append((y.float(), conv.weight.grad.clone()))
    for got, want in zip(*outs):
        assert got.dtype == torch.float32
        assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.parametrize("n,h,w", [(128, 112, 112), (128, 56, 56),
                                   (128, 28, 28), (2, 28, 28), (1, 1, 1),
                                   (3, 13, 17)])
def test_dw_geometry_covers_every_tile_once(n, h, w):
    per_chunk, chunks = dw_geometry(n, h, w)
    tiles = n * -(-h * w // DW_TILE)
    assert chunks <= DW_MAX_CHUNKS
    covered = [t for c in range(chunks)
               for t in range(c * per_chunk, min(tiles, (c + 1) * per_chunk))]
    assert covered == list(range(tiles))


def _fwd_by_tiles(x, w, bm=128):
    """fwd_f32's blocking in numpy: tiles of `bm` flattened
    pixels of one image, the staged rows r_lo - 1 .. r_hi + 1 with the
    zero padding, each pixel read at its staged position plus the tap."""
    n, c, h, wd = x.shape
    hw, wp = h * wd, wd + 2
    rows_staged = (wd + bm - 2) // wd + 3
    y = np.zeros((n, w.shape[0], hw), np.float64)
    for img in range(n):
        for p0 in range(0, hw, bm):
            r_lo = p0 // wd
            nr = (min(p0 + bm, hw) - 1) // wd - r_lo + 3
            assert nr <= rows_staged
            staged = np.zeros((c, nr, wp))
            for r in range(nr):
                gh = r_lo - 1 + r
                if 0 <= gh < h:
                    staged[:, r, 1:wd + 1] = x[img, :, gh]
            flat = staged.reshape(c, -1)
            for pm in range(bm):
                p = min(p0 + pm, hw - 1)
                pos = (p // wd - r_lo) * wp + p % wd
                if p0 + pm >= hw:
                    continue
                for tap in range(9):
                    v = flat[:, pos + (tap // 3) * wp + tap % 3]
                    y[img, :, p] += w[:, :, tap // 3, tap % 3] @ v
    return y.reshape(n, -1, h, wd)


def _dw_by_tiles(x, dy):
    """dw_f32's blocking in numpy: (tap, chunk) partials over 64-pixel
    tiles, then their sum in chunk order (dw_reduce)."""
    n, c, h, wd = x.shape
    hw = h * wd
    tpi = -(-hw // DW_TILE)
    per_chunk, chunks = dw_geometry(n, h, wd)
    partial = np.zeros((chunks, 9, dy.shape[1], c))
    for chunk in range(chunks):
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            for tt in range(chunk * per_chunk,
                            min(n * tpi, (chunk + 1) * per_chunk)):
                img, p0 = tt // tpi, (tt % tpi) * DW_TILE
                ds = np.zeros((dy.shape[1], DW_TILE))
                xs = np.zeros((c, DW_TILE))
                for pk in range(DW_TILE):
                    p = p0 + pk
                    if p >= hw:
                        continue
                    ds[:, pk] = dy[img, :, p // wd, p % wd]
                    gh, gw = p // wd + ky - 1, p % wd + kx - 1
                    if 0 <= gh < h and 0 <= gw < wd:
                        xs[:, pk] = x[img, :, gh, gw]
                partial[chunk, tap] += ds @ xs.T
    dw = partial.sum(0)  # (9, Co, Ci)
    return dw.transpose(1, 2, 0).reshape(dy.shape[1], c, 3, 3)


@pytest.mark.parametrize("n,h,w,bm", [(2, 5, 7, 16), (1, 9, 4, 16),
                                      (1, 3, 40, 32)])
def test_kernel_tiling_replayed_in_numpy(n, h, w, bm):
    """The f32 kernels' tile, halo and tail arithmetic gives the plain
    versions' results (small tiles, so that tiles cross image rows)."""
    rng = np.random.RandomState(8)
    x = rng.randn(n, 3, h, w)
    wt = rng.randn(4, 3, 3, 3)
    dy = rng.randn(n, 4, h, w)
    want = conv3x3_reference(torch.from_numpy(x), torch.from_numpy(wt))
    np.testing.assert_allclose(_fwd_by_tiles(x, wt, bm), want.numpy(),
                               atol=1e-10)
    want = conv3x3_dw_reference(torch.from_numpy(x), torch.from_numpy(dy))
    np.testing.assert_allclose(_dw_by_tiles(x, dy), want.numpy(), atol=1e-10)


def _round16(v):
    return -(-v // 16) * 16


def _units(geo, h, w):
    """-> [(block, image, h0, h1, c0, cw)] in the order dw_bf16 walks them."""
    out = []
    for b in range(geo.blocks):
        for u in range(b * geo.units_per_block,
                       min(geo.units, (b + 1) * geo.units_per_block)):
            run, strip = u % geo.runs, (u // geo.runs) % geo.strips
            c0, h0 = strip * geo.strip, run * geo.rows
            out.append((b, u // (geo.runs * geo.strips), h0,
                        min(h, h0 + geo.rows), c0, min(geo.strip, w - c0)))
    return out


def _dw_bf16_by_rows(x, dy):
    """dw_bf16's blocking in numpy, step for step: the units of each block,
    the ring of four x rows (slot (r - h0 + 1) & 3) in an aligned copy at
    the left pad DW_PAD and a copy shifted by one element, the ring of two
    dY rows, K padded to Wk with zero columns and zero rows, each tap's
    operand at the offset the kernel reads it (aligned copy at 8 for
    kx = 1, shifted copy at 6 or 8), the next rows staged before the
    current one is summed, then the partials added in block order. Shared
    memory starts as NaN, so that a read of anything not staged shows."""
    n, c, h, wd = x.shape
    co = dy.shape[1]
    geo = dw_rows_geometry(n, h, wd)
    xs_stride = dw_row_stride(_round16(geo.strip) + 2 * DW_PAD)
    ds_stride = dw_row_stride(_round16(geo.strip))
    partial = np.zeros((geo.blocks, 9, co, c))
    block = None
    for b, img, h0, h1, c0, cw in _units(geo, h, wd):
        if b != block:  # a block's shared memory, unwritten
            block = b
            xring = np.full((4, 2, c, xs_stride), np.nan)
            dring = np.full((2, co, ds_stride), np.nan)
        wk = _round16(cw)

        def xslot(r):
            return (r - h0 + 1) & 3

        def stage_x(r):
            cols = np.arange(c0 - DW_PAD, c0 + wk + DW_PAD)
            vals = np.zeros((c, cols.size))
            ok = (cols >= 0) & (cols < wd)
            if 0 <= r < h:
                vals[:, ok] = x[img, :, r, cols[ok]].T
            xring[xslot(r), 0, :, :cols.size] = vals

        def shift(r):
            s = xslot(r)
            xring[s, 1, :, :DW_PAD + wk] = xring[s, 0, :, 1:DW_PAD + wk + 1]

        def stage_dy(r):
            vals = np.zeros((co, wk))
            vals[:, :cw] = dy[img, :, r, c0:c0 + cw]
            dring[(r - h0) & 1, :, :wk] = vals

        stage_x(h0 - 1)
        stage_x(h0)
        shift(h0 - 1)
        shift(h0)
        stage_x(h0 + 1)
        stage_dy(h0)
        for row in range(h0, h1):
            shift(row + 1)
            if row + 1 < h1:
                stage_x(row + 2)
                stage_dy(row + 1)
            a = dring[(row - h0) & 1, :, :wk]
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                copy, off = (0, DW_PAD) if kx == 1 else (1, 6 if kx == 0
                                                         else 8)
                bt = xring[xslot(row + ky - 1), copy, :, off:off + wk]
                partial[b, tap] += a @ bt.T
    dw = np.zeros((9, co, c))
    for b in range(geo.blocks):  # dw_reduce: block order
        dw = dw + partial[b]
    return dw.transpose(1, 2, 0).reshape(co, c, 3, 3)


@pytest.mark.parametrize("n,h,w", [
    (1, 1, 1), (1, 2, 3), (2, 5, 17), (1, 7, 28), (2, 3, 56), (1, 3, 112),
    (1, 2, 129), (1, 2, 200), (40, 9, 20), (140, 1, 2)])
def test_dw_bf16_rows_replayed_in_numpy(n, h, w):
    """dw_bf16's runs, strips, row rings, shifted copies and padding give
    the plain dW, in f64 (odd W, W not a multiple of 16, W > 128 in two
    strips, runs of several rows, blocks of several units)."""
    rng = np.random.RandomState(9)
    x = rng.randn(n, 3, h, w)
    dy = rng.randn(n, 4, h, w)
    want = conv3x3_dw_reference(torch.from_numpy(x), torch.from_numpy(dy))
    np.testing.assert_allclose(_dw_bf16_by_rows(x, dy), want.numpy(),
                               atol=1e-10, rtol=0)


@pytest.mark.parametrize("n,h,w", [(128, 112, 112), (128, 56, 56),
                                   (128, 28, 28), (4, 112, 112), (3, 13, 17),
                                   (2, 5, 200), (1, 1, 512), (300, 3, 9),
                                   (1, 7, 129), (1, 1, 1)])
def test_dw_rows_geometry_covers_every_pixel_once(n, h, w):
    """Every (image, row, column) belongs to exactly one unit; strips
    start on 8-element boundaries and are at most DW_STRIP wide; about one
    block per SM (one per image at B = 128)."""
    geo = dw_rows_geometry(n, h, w)
    cover = np.zeros((n, h, w), int)
    units = _units(geo, h, w)
    for _, img, h0, h1, c0, cw in units:
        assert c0 % 8 == 0 and 1 <= cw <= DW_STRIP and h0 < h1
        cover[img, h0:h1, c0:c0 + cw] += 1
    assert (cover == 1).all()
    assert len(units) == geo.units and geo.blocks <= DW_BLOCKS
    assert geo.strip % 8 == 0 and geo.strip <= DW_STRIP
    if (n, h, w) == (128, 112, 112):
        assert (geo.blocks, geo.rows) == (128, 112)


def test_dw_shared_memory_fits_every_width():
    """The bf16 dW kernel's shared memory stays within an H100 block's
    232,448 bytes at every width the wrappers take, and its row strides
    keep 16-byte rows and conflict-free fragment loads."""
    sizes = [dw_smem_bytes(w) for w in range(1, MAX_WIDTH + 1)]
    assert max(sizes) <= MAX_SMEM == 232448
    for need in range(1, DW_STRIP + 2 * DW_PAD + 1):
        s = dw_row_stride(need)
        assert s >= need and s % 8 == 0 and (s // 2) % 8 == 4


def _round8(v):
    return -(-v // 8) * 8


def _fwd_tiles(wk, warps=FWD_WARPS):
    """-> [(warp group, n8 tile)] of one output row, as fwd_bf16's warps
    own them: group ng takes tiles ng, ng + NG, ... (NG = warps / 2; both
    halves of Co take the same tiles)."""
    groups = warps // 2
    return [(ng, ng + j * groups) for ng in range(groups)
            for j in range(16 // groups) if ng + j * groups < wk // 8]


def _fwd_bf16_by_rows(x, w):
    """fwd_bf16's blocking in numpy, step for step: the units of each
    block, the channel-major landing row (column c0 - DW_PAD + j at j, zero
    outside the image), its transpose into the pixel-major ring slot
    (r - h0 + 1) & 3 (pixel p = column c0 - 1 + p, p < Wk + 2), the rows
    h0 - 1 .. h1 made in the kernel's order (row h + 2 made before row h is
    summed), each warp's n8 tiles (N padded to 8), each tap's B operand at
    pixel w + kx of the slot of row h + ky - 1, and the store mask
    w < cw. Shared memory and y start as NaN, so that a read of anything
    not staged shows, and every output is stored once."""
    n, ci, h, wd = x.shape
    geo = dw_rows_geometry(n, h, wd)
    big = _round8(geo.strip)
    y = np.full((n, w.shape[0], h, wd), np.nan)
    block = None
    for b, img, h0, h1, c0, cw in _units(geo, h, wd):
        if b != block:  # a block's shared memory, unwritten
            block = b
            ring = np.full((X_SLOTS, big + 2, WS), np.nan)
            land = np.full((ci, big + 2 * DW_PAD), np.nan)
        wk = _round8(cw)

        def slot(r):
            return (r - h0 + 1) & (X_SLOTS - 1)

        def stage(r):
            cols = np.arange(c0 - DW_PAD, c0 + wk + DW_PAD)
            vals = np.zeros((ci, cols.size))
            ok = (cols >= 0) & (cols < wd)
            if 0 <= r < h:
                vals[:, ok] = x[img, :, r, cols[ok]].T
            land[:, :cols.size] = vals

        def advance(r):
            for jb in range((wk + 2 * DW_PAD) // 8):
                for i in range(8):
                    p = 8 * jb + i - (DW_PAD - 1)
                    if 0 <= p < wk + 2:
                        ring[slot(r), p, :ci] = land[:, 8 * jb + i]
            if r + 1 <= h1:
                stage(r + 1)

        stage(h0 - 1)
        for r in (h0 - 1, h0, h0 + 1):
            advance(r)
        for row in range(h0, h1):
            if row + 2 <= h1:
                advance(row + 2)
            for _, nt in _fwd_tiles(wk):
                acc = np.zeros((w.shape[0], 8))
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    bt = ring[slot(row + ky - 1),
                              nt * 8 + kx:nt * 8 + kx + 8, :ci]
                    acc += w[:, :, ky, kx] @ bt.T
                for k in range(8):
                    wc = nt * 8 + k
                    if wc < cw:
                        assert np.isnan(y[img, :, row, c0 + wc]).all()
                        y[img, :, row, c0 + wc] = acc[:, k]
    return y


FWD_ROW_SHAPES = [(1, 1, 1), (1, 2, 3), (2, 5, 17), (1, 7, 28), (2, 3, 56),
                  (1, 3, 112), (1, 2, 129), (1, 2, 200), (40, 9, 20),
                  (140, 1, 2)]
# the serving buckets' batches at the three site shapes: at B = 1 each
# block makes one output row, at B = 32 a run of 7 to 28 rows
BUCKET_SHAPES = [(n, s, s) for n in (1, 2, 8, 32) for s in (112, 56, 28)]


@pytest.mark.parametrize("part", ["forward", "dx"])
@pytest.mark.parametrize("n,h,w", FWD_ROW_SHAPES + BUCKET_SHAPES)
def test_fwd_bf16_rows_replayed_in_numpy(n, h, w, part):
    """fwd_bf16's runs, strips, landing row, pixel-major ring, halo, tap
    offsets, n8 tiles and store mask give the plain conv, forward and dX
    (the kernel on flipped weights), in f64 (odd W, W not a multiple of 8,
    W > 128 in two strips, runs of several rows, blocks of several
    units)."""
    rng = np.random.RandomState(10)
    x = rng.randn(n, 3, h, w)
    wt = rng.randn(4, 3, 3, 3)
    if part == "dx":
        x = rng.randn(n, 4, h, w)
        wt = flip_weights(torch.from_numpy(wt)).contiguous().numpy()
    want = conv3x3_reference(torch.from_numpy(x), torch.from_numpy(wt))
    np.testing.assert_allclose(_fwd_bf16_by_rows(x, wt), want.numpy(),
                               atol=1e-10, rtol=0)


@pytest.mark.parametrize("n,h,w", [(128, 112, 112), (128, 56, 56),
                                   (128, 28, 28), (512, 112, 112),
                                   (512, 28, 28), (3, 13, 17), (2, 5, 200),
                                   (1, 1, 512), (1, 7, 129), (300, 3, 9),
                                   (1, 1, 1), (4, 9, 57)] + BUCKET_SHAPES)
def test_fwd_rows_cover_every_output_once(n, h, w):
    """Every output pixel of every image is stored by exactly one (unit,
    row, warp group, n8 tile, column) of fwd_bf16; a warp owns at most
    16 / (FWD_WARPS / 2) tiles of a row (its accumulators)."""
    geo = dw_rows_geometry(n, h, w)
    cover = np.zeros((n, h, w), int)
    for _, img, h0, h1, c0, cw in _units(geo, h, w):
        tiles = _fwd_tiles(_round8(cw))
        assert sorted(nt for _, nt in tiles) == list(range(_round8(cw) // 8))
        per_group = np.bincount([ng for ng, _ in tiles])
        assert per_group.max() <= 16 // (FWD_WARPS // 2)
        for _, nt in tiles:
            cols = [c0 + wc for wc in range(nt * 8, nt * 8 + 8) if wc < cw]
            cover[img, h0:h1, cols] += 1
    assert (cover == 1).all()


def test_fwd_shared_memory_fits_every_width():
    """The bf16 forward's resident weights, ring of four pixel rows and
    landing row fit an H100 block's 232,448 bytes at every width the
    wrappers take (176,256 at strips of 128); rows stay 16-byte aligned."""
    sizes = [fwd_smem_bytes(w) for w in range(1, MAX_WIDTH + 1)]
    assert max(sizes) == fwd_smem_bytes(128) == 176256 <= MAX_SMEM
    assert fwd_smem_bytes(112) == 2 * (9 * 64 * 72 + 4 * 114 * 72 + 64 * 128)
    assert (WS * 2) % 16 == 0 and (WS // 2) % 32 == 4


def test_dw_vector_keeps_copies_aligned():
    base = torch.zeros(4096, dtype=torch.bfloat16)
    assert dw_vector(112, base) == 8
    assert dw_vector(28, base) == 4
    assert dw_vector(30, base) == 2
    assert dw_vector(17, base) == 1
    assert dw_vector(112, base[4:]) == 4 and dw_vector(112, base[1:]) == 1


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _nvcc.find_nvcc()


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """A stand-in nvcc that refuses the source: the build raises with its
    output, and nothing is left in the build directory."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'conv3x3.cu(1): error: no sm_90a here'"
                    " >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_nvcc, "BUILD_DIR", str(tmp_path / "build"))
    assert _nvcc.find_nvcc() == str(fake)
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _nvcc.load.__wrapped__("conv3x3")
    assert os.listdir(tmp_path / "build") == []


def test_two_threads_at_first_use_build_once(monkeypatch, tmp_path):
    """Two threads reach a library's first use together (a server's
    batcher and an /embed_batch handler): a stand-in nvcc that takes a
    while runs once, and both threads load its library."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    runs = tmp_path / "runs"
    fake.write_text(
        "#!/bin/sh\n"
        "if [ \"$1\" = --version ]; then echo 'stand-in nvcc'; exit 0; fi\n"
        f"echo build >> {runs}\n"
        "sleep 1\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        "echo lib > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_nvcc, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_nvcc.ctypes, "CDLL", lambda path: types.
                        SimpleNamespace(path=path, cuda_error_string=types.
                                        SimpleNamespace()))
    monkeypatch.setattr(_nvcc, "builds", {})
    start = threading.Barrier(2)
    libs, errors = [], []

    def first_use():
        start.wait()
        try:
            libs.append(_nvcc.load.__wrapped__("conv3x3"))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert not errors
    assert runs.read_text().splitlines() == ["build"]
    assert len(libs) == 2 and libs[0].path == libs[1].path
    assert list(_nvcc.builds) == ["conv3x3"]
    assert os.listdir(tmp_path / "build") == [os.path.basename(libs[0].path)]
