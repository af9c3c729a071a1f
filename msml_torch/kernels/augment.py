"""On-device augmentation: random block occlusion + Gaussian relight +
normalize, fused in one CUDA C++ kernel for Hopper (`csrc/augment.cu`).

Replaces the Pallas kernel `msml_tpu/kernels/augment.py::_gauss_block_kernel`
(launched by `pallas_augment_batch`, augment.py:131-211, `pallas_call` at
:202) and its jnp twins: `device_augment_batch` (augment.py:92-110), which
the on-device occlusion sweep calls, and `device_input_stage`
(augment.py:27-61), the training input stage of `device_light` mode. Per
image, with six uniform draws r0..r5 (augment.py:144-149), after a uint8
image is divided by 255 in f32:
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
(read + write; 5 for a uint8 image, 12 with gauss noise), so the least time
is the bytes over the HBM rate: at B = 512, 112 x 112 x 3 f32, 77.1 MB read
+ 77.1 MB written; the uint8 training stage at B = 128, 4.8 + 19.3 MB.

Design: one thread-block cluster per image (`augment_geometry`). The relit
image is divided by its own maximum, so no output can be written before
the whole image has been seen; a kernel with one block per image (the
Triton kernel this replaces) walks its image in serial tiles and, with
relight, reads it twice, with only B blocks in flight. Here K = 7 blocks
of 128 threads (fewer blocks for images under 7 rows) share each image.
Block (b, k) owns a band of ceil(H / K) rows, one contiguous NHWC run: it
copies the band into shared memory once (`cp.async` in PARTS = 2 groups,
so that the first half is worked on while the second arrives; 16 bytes a
copy where the pointers and the band's offset allow it, else 8, 4, or one
element). A thread takes groups of 4 pixels: it reads their 4 C staged
values (lanes 4 C elements apart: no bank conflict) and applies the fill
and the light per pixel.
  * Without relight (the sweep) it transposes NHWC -> NCHW in registers
    and writes each channel's 4 pixels with one 16-byte store where
    aligned (lanes on consecutive groups: 512 contiguous bytes a warp and
    channel). No cluster, no barrier after the copy.
  * With relight (the training stage) it writes the relit values into a
    channel-major tile [C][rows * W] in shared memory (the transpose, done
    once; one 16-byte store a channel and group, no bank conflict) and
    keeps their maximum. The warps' maxima go to slots in shared memory;
    after one cluster barrier every warp reads the K blocks' slots through
    distributed shared memory, and the block divides, normalizes and
    writes the tile along W, 16 bytes a store; a second barrier before
    exit keeps every block alive while a peer may read its slots.
The image is read from device memory once and written once, with B * K
blocks in flight. Why 7: the relight's stores wait for the whole cluster,
so a batch that does not fit on the card at once pays for a second wave.
An H100 holds 124 clusters of 8 blocks at once but 139 of 7
(`augment_occupancy`), so the training batch of 128 fits in one wave at
K = 7 and not at 8; the 7 bands of 16 rows also divide 112 (PERF.md,
PR 8, has the times at K = 6, 7 and 8). The f32 arithmetic follows the
plain version's order operation by operation (IEEE `sqrtf`; no
contraction into FMA; the divisions by 255 and by the maximum as a
product with the rounded reciprocal and one FMA correction, which is IEEE
division by Markstein's theorem), so the square's edges match it to the
pixel.

`augment_batch` launches the kernel for a CUDA tensor and runs the plain
PyTorch version `augment_batch_reference` for a CPU tensor; a failure to
build or launch the kernel raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from msml_torch.kernels import _nvcc

FILLS = {"black": 0, "white": 1, "gauss": 2}
CLUSTER = 7         # blocks per image (see the design note)
THREADS = 128       # a block's threads (csrc/augment.cu THREADS)
PARTS = 2           # copy groups a band is staged in (csrc PARTS)
SCRATCH = 16        # floats of shared memory after the band (csrc SCRATCH)
MAX_SMEM = 232448   # an H100 block's opt-in shared memory, bytes


class AugmentGeometry(NamedTuple):
    cluster: int    # K: blocks per image, the cluster's size
    rows: int       # image rows in a block's band, ceil(H / K)
    vec: int        # bytes per copy of the band into shared memory
    store_vec: int  # floats per store of the NCHW output
    smem: int       # dynamic shared memory per block, bytes
    blocks: int     # B * K


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def augment_geometry(b: int, h: int, w: int, c: int, dtype: torch.dtype,
                     *tensors: torch.Tensor,
                     relight: bool = False) -> AugmentGeometry:
    """The kernel's blocking for B images of (H, W, C) in `dtype` (float32
    or uint8): K = min(7, H) blocks per image, bands of ceil(H / K) rows;
    the widest copy (16, 8 or 4 bytes, else one element) that divides an
    image's bytes, a band's bytes and the address of each of `tensors`;
    the widest store (4, 2 or 1 floats) that divides H W and a band's
    pixels; and the shared memory of a block: the staged band, with
    `relight` the tile [C][rows * W rounded up to 4] f32, and the slots.

    Raises ValueError when a band does not fit in a block's shared memory.
    """
    esize = 1 if dtype == torch.uint8 else 4
    k = min(CLUSTER, h)
    rows = -(-h // k)
    band = rows * w * c * esize
    vec = next(v for v in (16, 8, 4, esize)
               if h * w * c * esize % v == 0 and band % v == 0
               and all(t.data_ptr() % v == 0 for t in tensors))
    store_vec = next(v for v in (4, 2, 1)
                     if h * w % v == 0 and rows * w % v == 0)
    tile = 4 * c * _round(rows * w, 4) if relight else 0
    smem = _round(band, 16) + tile + 4 * SCRATCH
    if smem > MAX_SMEM:
        raise ValueError(
            f"augment_batch: a band of {rows} rows of ({w}, {c}) needs "
            f"{smem} bytes of shared memory per block, above the limit of "
            f"{MAX_SMEM} (H = {h} over K = {k} blocks per image)")
    return AugmentGeometry(k, rows, vec, store_vec, smem, b * k)


def _check_args(img: torch.Tensor, draws: torch.Tensor,
                noise: Optional[torch.Tensor], lo: int, hi: int,
                fill: str) -> bool:
    """Validate the inputs; returns whether a block is drawn at all."""
    if img.dim() != 4 or img.shape[-1] not in (1, 3):
        raise ValueError(f"img must be (B, H, W, 1|3), got {tuple(img.shape)}")
    if img.dtype not in (torch.float32, torch.uint8) \
            or not img.is_contiguous():
        raise ValueError("img must be contiguous float32 or uint8")
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
    out = img.to(torch.float32) / 255.0 if img.dtype == torch.uint8 else img
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


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _nvcc.load("augment")
    _nvcc.signature(lib.augment_batch, pointers=4, ints=16)
    lib.augment_occupancy.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.augment_occupancy.restype = ctypes.c_int
    return lib


def augment_occupancy(geo: AugmentGeometry, dtype: torch.dtype):
    """(clusters of K relight blocks, blocks without a cluster per SM) that
    the card holds at once for this geometry: the kernel runs in one wave
    when B clusters (relight) or B K blocks fit."""
    lib = _lib()
    clusters, per_sm = ctypes.c_int(), ctypes.c_int()
    err = lib.augment_occupancy(int(dtype == torch.uint8), geo.cluster,
                                geo.smem, ctypes.byref(clusters),
                                ctypes.byref(per_sm))
    _nvcc.check(lib, err, "augment_occupancy")
    return clusters.value, per_sm.value


def augment_batch(img: torch.Tensor, draws: torch.Tensor,
                  noise: Optional[torch.Tensor] = None, *, lo: int = 0,
                  hi: int = 1, fill: str = "black", relight: bool = False,
                  use_norm: bool = True) -> torch.Tensor:
    """Block fill + relight + normalize: (B, H, W, C) f32 in [0, 1], or
    uint8 in [0, 255] (divided by 255 in f32 first, in the same pass) ->
    (B, C, H, W) f32. `draws`: (B, 6) uniforms in [0, 1); `noise`: unit
    normals shaped like `img`, read only by the gauss fill.

    CUDA tensors run the CUDA kernel, CPU tensors the plain version."""
    if img.device.type == "cpu":
        return augment_batch_reference(img, draws, noise, lo=lo, hi=hi,
                                       fill=fill, relight=relight,
                                       use_norm=use_norm)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    has_block = _check_args(img, draws, noise, lo, hi, fill)
    b, h, w, c = img.shape
    out = torch.empty((b, c, h, w), dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    geo = augment_geometry(b, h, w, c, img.dtype, img, relight=relight)
    gauss = fill == "gauss" and has_block
    lib = _lib()
    with torch.cuda.device(img.device):
        err = lib.augment_batch(
            img.data_ptr(), draws.data_ptr(),
            noise.data_ptr() if gauss else None, out.data_ptr(), b, h, w, c,
            int(img.dtype == torch.uint8), geo.cluster, geo.rows, geo.vec,
            geo.store_vec, geo.smem, lo, hi, FILLS[fill],
            int(has_block), int(relight), int(use_norm),
            torch.cuda.current_stream().cuda_stream)
    _nvcc.check(lib, err, "augment_batch")
    augment_batch.launches += 1
    return out


augment_batch.launches = 0  # kernel launches since the last reset


def device_input_stage(img: torch.Tensor, draws: Optional[torch.Tensor],
                       gauss_light: bool = True,
                       use_norm: bool = True) -> torch.Tensor:
    """The training input stage of `device_light` mode: uint8 (B, H, W, C)
    -> /255 -> Gaussian relight -> (x - 0.5) / 0.5, as (B, C, H, W) f32.

    `draws` (B, 3) are the relight's uniforms (u_cx, u_cy, u_scale), read
    only when `gauss_light`: cx = u_cx W, cy = u_cy H, scale = 0.7 + 0.7
    u_scale, the map of `device_gauss_light` (augment.py:51-54)."""
    b = img.shape[0]
    six = torch.zeros((b, 6), dtype=torch.float32, device=img.device)
    if gauss_light:
        six[:, 3:] = draws
    return augment_batch(img, six, relight=gauss_light, use_norm=use_norm)
