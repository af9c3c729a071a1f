"""The blocking of the cluster augment kernel (msml_torch/csrc/augment.cu)
on the CPU: `augment_geometry`, and a numpy replay of the kernel, step by
step, against the plain version.

The replay walks the blocks (b, k) of each image's cluster as the kernel
does: the staging of the band in PARTS copy groups of the chosen width
(every copy aligned, every byte copied once); the groups of 4 pixels of
each thread, stepping (x, y) as the kernel does; without relight the
finished values straight to the output; with relight the relit values in
the channel-major tile, each warp's maximum in its block's slots, the
cluster's exchange, and the tile's stores of the chosen width. Shared
memory and the output start as NaN, and every tile word and output element
must be written exactly once. It then has to equal `augment_batch_reference`
exactly in f32. The one libm call, exp, is torch's in both; the kernel's
own `expf` on the card is held against the plain version by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import itertools
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from msml_torch.kernels import _nvcc
from msml_torch.kernels.augment import (FILLS, MAX_SMEM, PARTS, SCRATCH,
                                        THREADS,
                                        augment_batch_reference,
                                        augment_geometry)

F32 = np.float32


def _offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of t that starts `offset` elements into its
    allocation."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype)[offset:]
    return flat.view(t.shape).copy_(t)


@pytest.mark.parametrize("b,h,w,c,dtype,want", [
    # 112^2 RGB f32 (the sweep) and uint8 (the training stage): 7 bands of 16
    (512, 112, 112, 3, torch.float32, (7, 16, 16, 4, 21568, 3584)),
    (128, 112, 112, 3, torch.uint8, (7, 16, 16, 4, 5440, 896)),
    # 128^2 gray (the JAX package's LightCNN input): bands of 19, the last 14
    (4, 128, 128, 1, torch.float32, (7, 19, 16, 4, 9792, 28)),
    # H < 7: one row a block, K = H; an odd H W: 4-byte copies, 1-float stores
    (2, 5, 7, 3, torch.float32, (5, 1, 4, 1, 160, 10)),
    # H not divisible by K: bands of 17, the last of 11
    (2, 113, 112, 3, torch.float32, (7, 17, 16, 4, 22912, 14)),
    (2, 113, 112, 3, torch.uint8, (7, 17, 16, 4, 5776, 14)),
    # odd W and odd band pixels: 4-byte copies of f32, byte copies of uint8,
    # 1-float stores
    (2, 16, 17, 3, torch.float32, (7, 3, 4, 1, 688, 14)),
    (2, 16, 17, 3, torch.uint8, (7, 3, 1, 1, 224, 14)),
    # H = 9 at K = 7: bands of 2, two blocks with no rows
    (3, 9, 17, 1, torch.float32, (7, 2, 4, 1, 208, 21)),
    # B = 1
    (1, 112, 112, 3, torch.float32, (7, 16, 16, 4, 21568, 7)),
])
def test_geometry(b, h, w, c, dtype, want):
    img = torch.zeros((b, h, w, c), dtype=dtype)
    geo = augment_geometry(b, h, w, c, dtype, img)
    assert tuple(geo) == want
    esize = 1 if dtype == torch.uint8 else 4
    assert geo.cluster == min(7, h) and geo.rows * geo.cluster >= h
    assert (geo.rows - 1) * geo.cluster < h
    assert geo.smem == -(-geo.rows * w * c * esize // 16) * 16 + 4 * SCRATCH


@pytest.mark.parametrize("dtype,tile", [(torch.float32, 21504),
                                        (torch.uint8, 21504)])
def test_geometry_relight_adds_the_tile(dtype, tile):
    """With relight a block also holds its band's relit values, f32 in
    [C][rows * W rounded up to 4]: 21,504 bytes at 112^2 RGB."""
    plain = augment_geometry(128, 112, 112, 3, dtype)
    relit = augment_geometry(128, 112, 112, 3, dtype, relight=True)
    assert relit.smem - plain.smem == tile
    assert relit._replace(smem=plain.smem) == plain
    odd = augment_geometry(2, 9, 17, 1, dtype, relight=True)
    assert odd.smem - augment_geometry(2, 9, 17, 1, dtype).smem == 4 * 36


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4),
                                       (torch.uint8, 1)])
def test_geometry_one_element_off(dtype, vec):
    """A base pointer one element past a 16-byte boundary takes copies of
    one element; the aligned tensor of the same shape takes 16 bytes."""
    img = torch.zeros((2, 112, 112, 3), dtype=dtype)
    assert augment_geometry(2, 112, 112, 3, dtype, img).vec == 16
    off = _offset(img, 1)
    assert off.data_ptr() % 16 == off.element_size()
    assert augment_geometry(2, 112, 112, 3, dtype, off).vec == vec


def test_geometry_raises_above_the_shared_memory_limit():
    geo = augment_geometry(1, 224, 512, 3, torch.float32)
    assert geo.smem == 196672 <= MAX_SMEM  # 32 rows of 512 x 3 f32 fit
    with pytest.raises(ValueError, match=str(MAX_SMEM)):
        augment_geometry(1, 64, 4096, 3, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        augment_geometry(1, 2048, 2048, 3, torch.uint8)


# ------------------------------------------------------------- the replay
def _draws(d, h, w, lo, hi):
    """image_draws of csrc/augment.cu: f32 operation by operation."""
    wf = F32(w)
    ratio = (F32(lo) + np.floor(d[0] * F32(hi - lo))) * F32(0.01)
    bw = np.floor(np.sqrt(ratio) * wf)
    span = (wf - bw) + F32(1.0)
    x0 = np.floor(d[1] * span)
    y0 = np.floor(d[2] * span)
    return dict(x0=x0, x1=x0 + bw, y0=y0, y1=y0 + bw, cx=d[3] * wf,
                cy=d[4] * F32(h), scale=d[5] * F32(0.7) + F32(0.7))


def _exp(a):
    return torch.exp(torch.from_numpy(a)).numpy()


def _walk(p0, p1, w, row0, visit):
    """walk: thread t takes the groups of 4 pixels g = p0 / 4 + t,
    + THREADS, ..., stepping (x, y) as the kernel does, then the last
    (p1 - p0) mod 4 pixels one a thread; visit(on, lp, x, y) gets the
    threads `on` and their pixels (arrays)."""
    t = np.arange(THREADS)
    g1 = p0 // 4 + (p1 - p0) // 4
    g = p0 // 4 + t
    x, y = 4 * g % w, row0 + 4 * g // w
    while (g < g1).any():
        on = g < g1
        for j in range(4):
            xj, yj = x[on] + j, y[on].copy()
            while (xj >= w).any():  # a group that runs into the next row(s)
                yj = np.where(xj >= w, yj + 1, yj)
                xj = np.where(xj >= w, xj - w, xj)
            visit(on, 4 * g[on] + j, xj, yj)
        g = g + THREADS
        x, y = x + 4 * THREADS % w, y + 4 * THREADS // w
        y, x = np.where(x >= w, y + 1, y), np.where(x >= w, x - w, x)
    lp = 4 * g1 + t
    on = lp < p1
    visit(on, lp[on], lp[on] % w, row0 + lp[on] // w)


def _store_steps(npix, c, sv):
    """(channel, first pixel) of each vector store of tile_store, thread
    by thread, as it steps through the band's C runs laid end to end."""
    for t in range(THREADS):
        ch, i = 0, t * sv
        while True:
            while i >= npix and ch < c:
                i -= npix
                ch += 1
            if ch == c:
                break
            yield ch, i
            i += THREADS * sv


def _finish(v, denom, use_norm):
    if denom is not None:
        v = v / denom
    return (v - F32(0.5)) / F32(0.5) if use_norm else v


def replay(img: torch.Tensor, draws, noise, *, lo, hi, fill, relight,
           use_norm) -> np.ndarray:
    b, h, w, c = img.shape
    u8 = img.dtype == torch.uint8
    esize = 1 if u8 else 4
    geo = augment_geometry(b, h, w, c, img.dtype, img, relight=relight)
    k_all, rows, vec, sv = geo[:4]
    band_bytes = -(-rows * w * c * esize // 16) * 16
    plane = -(-rows * w // 4) * 4
    assert geo.smem == band_bytes + (4 * c * plane if relight else 0) \
        + 4 * SCRATCH
    has_block = hi > 1 or lo > 0
    gauss = fill == "gauss" and has_block
    src = img.numpy().reshape(-1).view(np.uint8)  # the image bytes
    base = img.data_ptr()
    nz = noise.numpy().reshape(-1) if gauss else None
    out = np.full(b * c * h * w, np.nan, F32)
    written = np.zeros(out.shape, np.int64)
    t = np.arange(THREADS)

    def write(dst, v):
        assert np.isnan(out[dst]).all()
        out[dst] = v
        written[dst] += 1

    for bi in range(b):
        d = _draws(draws[bi].numpy(), h, w, lo, hi)
        slots = np.full((k_all, THREADS // 32), np.nan, F32)
        tiles = {}
        for k in range(k_all):  # up to the cluster barrier
            smem = np.full(geo.smem, 0xFF, np.uint8)  # NaN in every word
            row0 = min(h, k * rows)
            npix = (min(h, row0 + rows) - row0) * w
            first = ((bi * h + row0) * w * c) * esize  # the band's byte
            band = smem[:npix * c * esize]
            seen = np.zeros(band.size, np.int64)
            cut = [npix * i // PARTS // 16 * 16 for i in range(PARTS)]
            cut.append(npix)  # PARTS copy groups of multiples of 16 pixels
            cuts = [(cut[i] * c * esize, cut[i + 1] * c * esize)
                    for i in range(PARTS)]
            for lo_b, hi_b in cuts:  # stage<VEC>
                assert lo_b % vec == 0 and hi_b % vec == 0
                for i in range(lo_b, hi_b, THREADS * vec):
                    for off in i + t * vec:
                        if off < hi_b:
                            assert (base + first + off) % vec == 0
                            band[off:off + vec] = src[first + off:
                                                      first + off + vec]
                            seen[off:off + vec] += 1
            assert (seen == 1).all()
            vals = band.astype(F32) / F32(255.0) if u8 else band.view(F32)
            tile = smem[band_bytes:band_bytes + 4 * c * plane].view(F32)
            m = np.full(THREADS, -np.inf, F32)
            out0 = ((bi * c) * h + row0) * w  # channel 0 of the band

            def visit(on, lp, x, y, row0=row0, vals=vals, first=first,
                      tile=tile, m=m, out0=out0):
                """pixel, element, then the tile and m (relight) or the
                finished values straight to the output (direct)."""
                xf, yf = x.astype(F32), y.astype(F32)
                inside = has_block & (xf >= d["x0"]) & (xf < d["x1"]) \
                    & (yf >= d["y0"]) & (yf < d["y1"])
                if relight:
                    dx, dy = xf - d["cx"], yf - d["cy"]
                    light = _exp((dx * dx + dy * dy) * F32(-2.0 ** -15)) \
                        * d["scale"]
                for ch in range(c):
                    e = lp * c + ch
                    v = vals[e]
                    if gauss:
                        v = np.where(inside, nz[first // esize + e], v)
                    elif has_block:
                        v = np.where(inside, F32(FILLS[fill]), v)
                    if relight:
                        v = v * light
                        m[on] = np.maximum(m[on], v)
                        assert np.isnan(tile[ch * plane + lp]).all()
                        tile[ch * plane + lp] = v
                    else:
                        write(out0 + ch * h * w + lp,
                              _finish(v, None, use_norm))

            for i in range(PARTS):
                _walk(cut[i], cut[i + 1], w, row0, visit)
            if not relight:
                for ch, g0 in itertools.product(range(c),
                                                range(0, npix - 3, 4)):
                    assert (out0 + ch * h * w + g0) % sv == 0  # store4<SV>
                continue
            tiles[k] = (tile, row0, npix)
            slots[k] = m.reshape(-1, 32).max(1)  # each warp's maximum
        if not relight:
            continue
        assert not np.isnan(slots).any()
        denom = max(slots.max(), F32(1e-6))  # every warp reads every slot
        for k, (tile, row0, npix) in tiles.items():  # tile_store<SV>
            for ch, i in _store_steps(npix, c, sv):
                dst = ((bi * c + ch) * h + row0) * w + i
                assert dst % sv == 0 and (ch * plane + i) % sv == 0
                write(np.arange(dst, dst + sv),
                      _finish(tile[ch * plane + i:ch * plane + i + sv],
                              denom, use_norm))
    assert (written == 1).all()
    return out.reshape(b, c, h, w)


SHAPES = [(2, 112, 112, 3), (1, 128, 128, 1), (2, 5, 7, 3), (3, 9, 17, 1),
          (2, 113, 21, 3), (2, 16, 17, 3), (1, 1, 3, 3), (2, 30, 40, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_replayed_in_numpy(shape, dtype):
    b, h, w, c = shape
    rng = np.random.RandomState(sum(shape))
    if dtype == torch.uint8:
        img = torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8))
    else:
        img = torch.from_numpy(rng.uniform(0, 1, shape).astype(F32))
    draws = torch.from_numpy(rng.uniform(0, 1, (b, 6)).astype(F32))
    noise = torch.from_numpy(rng.standard_normal(shape).astype(F32))
    for i, (fill, relight, (lo, hi)) in enumerate(itertools.product(
            ("black", "white", "gauss"), (True, False),
            ((0, 1), (20, 51)))):
        x = _offset(img, 1) if i % 2 else img  # aligned and one element off
        kw = dict(lo=lo, hi=hi, fill=fill, relight=relight,
                  use_norm=i % 3 != 0)
        want = augment_batch_reference(x, draws, noise, **kw).numpy()
        np.testing.assert_array_equal(replay(x, draws, noise, **kw), want)


def test_replay_sees_the_cluster_exchange():
    """The maximum that divides a relit band is its image's, not its own:
    a bright spot in one band darkens the other bands of the image."""
    img = torch.full((1, 16, 8, 1), 0.25)
    img[0, 1, 2, 0] = 1.0  # in band 0 of 8
    draws = torch.tensor([[0.0, 0.0, 0.0, 0.25, 0.0, 0.5]])
    kw = dict(lo=0, hi=1, fill="black", relight=True, use_norm=False)
    got = replay(img, draws, None, **kw)
    np.testing.assert_array_equal(
        got, augment_batch_reference(img, draws, **kw).numpy())
    assert got.max() == 1.0 and got[0, 0, 8:].max() < 0.25


def _rn(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, F32(-np.inf)), f, np.nextafter(f, F32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.array(v).view(np.uint32)) & 1))


def _div_rn(a, b, y):
    """div_rn of csrc/augment.cu with exact FMAs: q = RN(a y), then
    RN(q + RN(a - b q) y)."""
    fa, fb, fy = (Fraction(float(v)) for v in (a, b, y))
    q = _rn(fa * fy)
    e = _rn(fa - fb * Fraction(float(q)))
    return _rn(Fraction(float(q)) + Fraction(float(e)) * fy)


def test_division_by_reciprocal_and_one_fma_is_ieee_division():
    """The kernel divides by 255 and by the image's maximum as a product
    with the rounded reciprocal and one FMA correction; that is IEEE
    division, which the plain version does: for all 256 uint8 values, and
    for relit values over maxima from the 1e-6 floor to 3."""
    inv255 = _rn(Fraction(1, 255))
    assert inv255 == F32(float.fromhex("0x1.010102p-8"))
    for x in range(256):
        assert _div_rn(F32(x), F32(255), inv255) == F32(x) / F32(255)
    rng = np.random.RandomState(0)
    for a, b in zip(np.concatenate([rng.uniform(0, 1.4, 300),
                                    rng.standard_normal(300) * 2]),
                    np.concatenate([rng.uniform(1e-6, 1e-3, 300),
                                    rng.uniform(0.05, 3.0, 300)])):
        a, b = F32(a), F32(b)
        assert _div_rn(a, b, _rn(1 / Fraction(float(b)))) == a / b


def test_build_compiles_the_augment_source(monkeypatch, tmp_path):
    """The wrapper's library is built from csrc/augment.cu for sm_90a (a
    stand-in nvcc that names its input and refuses it): the build raises
    with the compiler's output and leaves nothing in the build directory."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text('#!/bin/sh\nfor a; do last=$a; done\n'
                    'echo "$* -> $(basename $last): refused" >&2\nexit 2\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_nvcc, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError,
                       match=r"arch=compute_90a,code=sm_90a.*augment\.cu: "
                             "refused"):
        _nvcc.load.__wrapped__("augment")
    assert os.listdir(tmp_path / "build") == []
