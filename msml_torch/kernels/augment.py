"""On-device augmentation: random block occlusion + Gaussian relight +
normalize, fused in one Triton kernel for Hopper.

Replaces the Pallas kernel `msml_tpu/kernels/augment.py::_gauss_block_kernel`
(launched by `pallas_augment_batch`, augment.py:131-211) and its jnp twin
`device_augment_batch` (augment.py:92-110), which the on-device occlusion
sweep calls. Per image, with six uniform draws r0..r5 (augment.py:144-149):
  1. block fill: ratio = (lo + floor(r0 (hi - lo))) / 100,
     bw = floor(sqrt(ratio) W), x0 = floor(r1 (W - bw + 1)),
     y0 = floor(r2 (W - bw + 1)) (W for both, as the reference draws it);
     the square is filled with 0 (black), 1 (white) or `noise` (gauss);
  2. relight: light = (0.7 + 0.7 r5) exp(-d^2 / (2 * 128^2)) centred at
     (r3 W, r4 H), then division by the image's own max, floored at 1e-6;
  3. normalize: (x - 0.5) / 0.5.

Differences from the TPU kernel, by design:
  * The caller draws r0..r5 (`draws`, (B, 6)) and the gauss-fill noise from
    a `torch.Generator` and passes them in; the TPU kernel drew them on-core.
    Kernel and plain version therefore see the same numbers.
  * The gauss fill is unit-normal noise (`torch.randn`), as on the jnp path
    the sweep uses (augment.py:85-86), not the Pallas kernel's uniform bits
    scaled to unit variance (augment.py:164-166).
  * It reads NHWC and writes NCHW, the model's layout, in the same pass.

Bound on the card: memory. Each element costs ~10 flops against 8 bytes
(read + write, 12 with gauss noise), so the least time is the bytes over the
HBM rate: at B = 512, 112 x 112 x 3 f32, 77.1 MB read + 77.1 MB written.
Design: one program per image. A tile is (rows, W, C) padded to powers of
two, so the NHWC load runs along C and the NCHW store along W and Triton
coalesces both (a first version with flat (rows, W*C) tiles scattered its
stores and took 4x longer). With relight, a first loop over the row tiles
finds the relit image's max; the second recomputes each tile, scales,
normalizes and stores, reading the image a second time.

`augment_batch` takes the Triton kernel for a CUDA tensor and the plain
PyTorch version `augment_batch_reference` for a CPU tensor; a failure to
build or launch the kernel raises.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch

FILLS = {"black": 0, "white": 1, "gauss": 2}
_TRITON_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "triton")
_TILE = 4096  # elements per tile (padded): 8 rows of 128 x 4 for RGB

tl = None  # triton.language, bound by _kernel() at the first launch


def _check_args(img: torch.Tensor, draws: torch.Tensor,
                noise: Optional[torch.Tensor], lo: int, hi: int,
                fill: str) -> bool:
    """Validate the inputs; returns whether a block is drawn at all."""
    if img.dim() != 4 or img.shape[-1] not in (1, 3):
        raise ValueError(f"img must be (B, H, W, 1|3), got {tuple(img.shape)}")
    if img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError("img must be contiguous float32")
    if tuple(draws.shape) != (img.shape[0], 6) \
            or draws.dtype != torch.float32 or not draws.is_contiguous() \
            or draws.device != img.device:
        raise ValueError("draws must be contiguous float32 (B, 6) on the "
                         "image's device")
    if fill not in FILLS:
        raise ValueError(f"fill must be one of {sorted(FILLS)}, got {fill!r}")
    if not 0 <= lo < hi <= 101:
        raise ValueError(f"need 0 <= lo < hi <= 101, got lo={lo} hi={hi}")
    has_block = hi > 1 or lo > 0
    if fill == "gauss" and has_block:
        if noise is None or noise.shape != img.shape \
                or noise.dtype != torch.float32 \
                or not noise.is_contiguous() or noise.device != img.device:
            raise ValueError("the gauss fill needs contiguous float32 noise "
                             "shaped like img on the image's device")
    return has_block


def augment_batch_reference(img: torch.Tensor, draws: torch.Tensor,
                            noise: Optional[torch.Tensor] = None, *,
                            lo: int = 0, hi: int = 1, fill: str = "black",
                            relight: bool = False,
                            use_norm: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, H, W, C) -> (B, C, H, W)."""
    has_block = _check_args(img, draws, noise, lo, hi, fill)
    b, h, w, c = img.shape
    r0, r1, r2, r3, r4, r5 = (t.view(b, 1, 1) for t in draws.unbind(1))
    xs = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)
    out = img
    if has_block:
        ratio = (lo + torch.floor(r0 * (hi - lo))) * 0.01
        bw = torch.floor(torch.sqrt(ratio) * w)
        x0 = torch.floor(r1 * (w - bw + 1.0))
        y0 = torch.floor(r2 * (w - bw + 1.0))
        inside = ((xs >= x0) & (xs < x0 + bw)
                  & (ys >= y0) & (ys < y0 + bw)).unsqueeze(-1)
        fill_val = noise if fill == "gauss" else float(FILLS[fill])
        out = torch.where(inside, fill_val, out)
    if relight:
        cx, cy, scale = r3 * w, r4 * h, 0.7 + r5 * 0.7
        d2 = (xs - cx) * (xs - cx) + (ys - cy) * (ys - cy)
        light = torch.exp(-0.5 * d2 / 16384.0) * scale
        out = out * light.unsqueeze(-1)
        mx = out.amax(dim=(1, 2, 3), keepdim=True)
        out = out / torch.clamp(mx, min=1e-6)
    if use_norm:
        out = (out - 0.5) / 0.5
    return out.permute(0, 3, 1, 2).contiguous()


def augment_batch(img: torch.Tensor, draws: torch.Tensor,
                  noise: Optional[torch.Tensor] = None, *, lo: int = 0,
                  hi: int = 1, fill: str = "black", relight: bool = False,
                  use_norm: bool = True) -> torch.Tensor:
    """Block fill + relight + normalize: (B, H, W, C) f32 in [0, 1] ->
    (B, C, H, W) f32. `draws`: (B, 6) uniforms in [0, 1); `noise`: unit
    normals shaped like `img`, read only by the gauss fill.

    CUDA tensors run the Triton kernel, CPU tensors the plain version."""
    if img.device.type == "cpu":
        return augment_batch_reference(img, draws, noise, lo=lo, hi=hi,
                                       fill=fill, relight=relight,
                                       use_norm=use_norm)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    has_block = _check_args(img, draws, noise, lo, hi, fill)
    b, h, w, c = img.shape
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=img.device)
    if b == 0:
        return out
    block_w = 1 << (w - 1).bit_length()
    block_c = max(2, 1 << (c - 1).bit_length())  # gray pads C to 2
    rows = max(1, _TILE // (block_w * block_c))
    kernel = _kernel()
    with torch.cuda.device(img.device):
        kernel[(b,)](
            img, draws, noise if noise is not None else img, out, h, w,
            C=c, LO=lo, HI=hi, FILL=FILLS[fill], HAS_BLOCK=has_block,
            RELIGHT=relight, USE_NORM=use_norm, ROWS=rows, BLOCK_W=block_w,
            BLOCK_C=block_c, num_warps=4)
    augment_batch.launches += 1
    return out


augment_batch.launches = 0  # kernel launches since the last reset


@functools.lru_cache(maxsize=None)
def _kernel():
    """Import Triton and JIT-decorate the kernel sources (first launch only).

    Triton's cache goes to `msml_torch/_build/triton` unless TRITON_CACHE_DIR
    is set, so a checkout builds its kernel from its own sources."""
    global tl, _augment_tile
    os.environ.setdefault("TRITON_CACHE_DIR", _TRITON_CACHE)
    import triton
    import triton.language as tl  # noqa: F811  (binds the module global)

    _augment_tile = triton.jit(_augment_tile)
    return triton.jit(_augment_kernel)


# ---------------------------------------------------------------- Triton
# The two functions below are Triton sources; _kernel() decorates them.

def _augment_tile(img_ptr, noise_ptr, off, y, x, mask, x0, y0, bw, cx, cy,
                  scale, HAS_BLOCK: tl.constexpr, FILL: tl.constexpr,
                  RELIGHT: tl.constexpr):
    """One tile of the image after the block fill and the light (before the
    division by the max)."""
    v = tl.load(img_ptr + off, mask=mask, other=0.0)
    xf = x.to(tl.float32)
    yf = y.to(tl.float32)
    if HAS_BLOCK:
        inside = (xf >= x0) & (xf < x0 + bw) & (yf >= y0) & (yf < y0 + bw)
        if FILL == 0:
            v = tl.where(inside, 0.0, v)
        elif FILL == 1:
            v = tl.where(inside, 1.0, v)
        else:
            v = tl.where(inside, tl.load(noise_ptr + off, mask=mask & inside,
                                         other=0.0), v)
    if RELIGHT:
        d2 = (xf - cx) * (xf - cx) + (yf - cy) * (yf - cy)
        v = v * (tl.exp(-0.5 * d2 / 16384.0) * scale)
    return v


def _augment_kernel(img_ptr, draws_ptr, noise_ptr, out_ptr, H, W,
                    C: tl.constexpr, LO: tl.constexpr, HI: tl.constexpr,
                    FILL: tl.constexpr, HAS_BLOCK: tl.constexpr,
                    RELIGHT: tl.constexpr, USE_NORM: tl.constexpr,
                    ROWS: tl.constexpr, BLOCK_W: tl.constexpr,
                    BLOCK_C: tl.constexpr):
    """One program per image: img (B, H, W, C) -> out (B, C, H, W).

    Tiles are (ROWS, BLOCK_W, BLOCK_C): addresses run along C on the NHWC
    load and along W on the NCHW store, so Triton can coalesce both."""
    b = tl.program_id(0).to(tl.int64)
    d = draws_ptr + b * 6
    r0 = tl.load(d)
    r1 = tl.load(d + 1)
    r2 = tl.load(d + 2)
    r3 = tl.load(d + 3)
    r4 = tl.load(d + 4)
    r5 = tl.load(d + 5)
    wf = W.to(tl.float32)
    ratio = (LO + tl.floor(r0 * (HI - LO))) * 0.01
    bw = tl.floor(tl.sqrt_rn(ratio) * wf)
    x0 = tl.floor(r1 * (wf - bw + 1.0))
    y0 = tl.floor(r2 * (wf - bw + 1.0))
    cx = r3 * wf
    cy = r4 * H.to(tl.float32)
    scale = 0.7 + r5 * 0.7

    # one 64-bit step to the image, 32-bit offsets inside it
    base = b * H * W * C
    img_ptr += base
    noise_ptr += base
    out_ptr += base
    rows = tl.arange(0, ROWS)[:, None, None]
    x = tl.arange(0, BLOCK_W)[None, :, None]
    ch = tl.arange(0, BLOCK_C)[None, None, :]
    xc_ok = (x < W) & (ch < C)

    if RELIGHT:
        acc = tl.full((ROWS, BLOCK_W, BLOCK_C), float("-inf"), tl.float32)
        for y_start in range(0, H, ROWS):
            y = y_start + rows
            mask = (y < H) & xc_ok
            v = _augment_tile(img_ptr, noise_ptr, (y * W + x) * C + ch,
                              y, x, mask, x0, y0, bw, cx, cy, scale,
                              HAS_BLOCK, FILL, RELIGHT)
            acc = tl.maximum(acc, tl.where(mask, v, float("-inf")))
        denom = tl.maximum(tl.max(tl.max(tl.max(acc, axis=2), axis=1),
                                  axis=0), 1e-6)

    for y_start in range(0, H, ROWS):
        y = y_start + rows
        mask = (y < H) & xc_ok
        v = _augment_tile(img_ptr, noise_ptr, (y * W + x) * C + ch,
                          y, x, mask, x0, y0, bw, cx, cy, scale,
                          HAS_BLOCK, FILL, RELIGHT)
        if RELIGHT:
            v = v / denom
        if USE_NORM:
            v = (v - 0.5) / 0.5
        tl.store(out_ptr + (ch * H + y) * W + x, v, mask=mask)
