"""The C = 64 3x3 stride-1 convolution, forward, dX and dW, as CUDA C++
kernels for Hopper.

Replaces the Pallas kernels of `benchmarks/negative/conv_gemm.py`:
`_fwd_kernel` (:109, launched by `conv3x3_lanes`, `pallas_call` at :151),
which also computes dX from flipped weights (:31-34, :101-103), and
`_dw_kernel` (:186, launched by `conv3x3_dw_lanes`, `pallas_call` at :241).
The public functions mirror `conv3x3_gemm`, `conv3x3_gemm_dw` and
`flip_weights` there, in NCHW with torch's OIHW weights (Co, Ci, 3, 3):

  conv3x3_fwd(x, w)   y = the 3x3 conv of x with zero padding 1, in x's
                      dtype (bf16 or f32), accumulated in f32
  conv3x3_dw(x, dy)   dW (Co, Ci, 3, 3) in f32
  flip_weights(w)     the weights of the dX conv: dX = conv3x3_fwd(dy,
                      flip_weights(w))
  conv3x3(x, w)       the torch.autograd.Function over the three

The TPU kernel packed the batch into its 128 lanes to fill them at C = 64;
the port keeps NCHW and reads neither layout transposed.

Bound on the card. At the 112 x 112 site and B = 128 a pass does
2 * 128 * 112^2 * 576 * 64 = 118.4 GFLOP (0.120 ms at 989 TFLOP/s bf16)
and moves x and y, 2 * 205.5 MB (0.123 ms at 3.35 TB/s): both bounds are
close, bytes a little ahead. In f32 the bound is the 67 TFLOP/s of FFMA.

Design (see PERF.md for its times):
- forward, bf16 (`fwd_bf16`): per output row a GEMM with M = Co = 64,
  N = the row's pixels and K = 9 Ci. The version it replaced ran one block
  per 128 flattened pixels (12,544 blocks at 112^2): each reloaded all
  73.7 KB of weights, staged ~4 input rows with their halo by 2-byte loads
  (x crossed L2 ~3.5 times) and had no pipeline. Now a persistent block
  walks runs of output rows of one image (`dw_rows_geometry`, as dW; one
  image per block at B = 128, column strips of at most 128), keeps the
  packed weights resident in shared memory for its whole life, and keeps
  a ring of four pixel-major x rows (rows h - 1, h, h + 1 in use, h + 2
  being made): each row arrives once by 16-byte `cp.async` into a
  channel-major landing row and is transposed once into its ring slot,
  two channels to a 32-bit word, while row h + 3 is in flight. A tap
  reads pixel w + kx of the slot of row h + ky - 1: a pixel is a whole
  slot row, so the odd tap offsets need no shifted copy. The 8 warps
  (`FWD_WARPS`) own (half of Co, every fourth n8 tile of the row) and run
  `mma.sync.m16n8k16` (f32 accumulators); the result is rounded to bf16
  once and stored along W from the registers.
- forward, f32 (`fwd_f32`): one block owns 128 flattened pixels of one
  image and all 64 output channels; per chunk of 16 input channels it
  stages the rows it needs (halo and zero padding) and the chunk's
  weights, then sums the 9 taps in plain FFMA (no TF32).
- dW: dW[co, ci, ky, kx] = sum over n, h, w of dy[n, co, h, w] *
  x[n, ci, h + ky - 1, w + kx - 1], a GEMM with M = Co, N = 9 Ci and K =
  N H W pixels. The TPU kernel added into its output across a sequential
  grid; Hopper's blocks run in no order, so each block sums into its own
  f32 partial, and a second, small launch sums the partials in block
  order: no atomics, the same bits on every run. Both launches are the one
  `conv3x3_dw` kernel and count as one launch. In bf16 (`dw_bf16`) a block
  walks runs of output rows of one image (`dw_rows_geometry`), in column
  strips of at most 128, and keeps a ring of x rows (three in use, one
  arriving by `cp.async`) and of dY rows in shared memory: every row is
  staged once for all nine taps, which 18 warps, one per (tap, half of
  Co), take on the tensor cores. The odd tap shifts read a second copy of
  each x row shifted by one element, so that every operand pair starts at
  an even element. In f32 (`dw_f32`) block (tap, chunk) sums its chunk
  of 64-pixel tiles (`dw_geometry`) in plain FFMA.
Not yet: `wgmma`, TMA, `ldmatrix`.

On a CPU tensor the wrappers run the plain versions, `conv3x3_reference`
and `conv3x3_dw_reference`: the sum over the nine taps of an `einsum` of
the shifted input, the TPU kernel's tap decomposition, in f32 (f64 for f64
inputs). On a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from msml_torch.kernels import _nvcc

C = 64                # the only channel count the kernels take
DW_TILE = 64          # pixels per f32 dW tile (BK in csrc/conv3x3.cu)
DW_MAX_CHUNKS = 256   # f32 dW partials at most (a chunk is a run of tiles)
DW_STRIP = 128        # widest column strip of a bf16 dW block
DW_BLOCKS = 132       # bf16 dW blocks aimed at: one per SM of an H100
DW_PAD = 8            # elements left of column 0 in a staged bf16 x row
MAX_WIDTH = 512       # the f32 forward's staged rows fit in shared memory
MAX_SMEM = 232448     # an H100 block's opt-in shared memory
FWD_WARPS = 8         # warps of a bf16 forward block (FWD_THREADS / 32)
WS = C + 8            # stride of a resident weight row and a ring pixel (halves)
X_SLOTS = 4           # pixel-major x rows in the bf16 forward's ring
_DTYPES = (torch.float32, torch.bfloat16)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _taps(x: torch.Tensor):
    """(ky, kx, the input shifted by the tap), zero outside the image."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    for ky in range(3):
        for kx in range(3):
            yield ky, kx, xp[:, :, ky:ky + h, kx:kx + w]


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain 3x3 stride-1 conv with zero padding 1: x (N, Ci, H, W), w
    (Co, Ci, 3, 3) -> (N, Co, H, W) in x's dtype, summed in f32."""
    acc = _acc_dtype(x.dtype)
    wa = w.to(acc)
    y = None
    for ky, kx, xs in _taps(x.to(acc)):
        term = torch.einsum("nchw,oc->nohw", xs, wa[:, :, ky, kx])
        y = term if y is None else y + term
    return y.to(x.dtype)


def conv3x3_dw_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain weight gradient of `conv3x3_reference`: (Co, Ci, 3, 3) in f32
    (f64 for f64 inputs)."""
    acc = _acc_dtype(x.dtype)
    d = dy.to(acc)
    taps = [torch.einsum("nohw,nchw->oc", d, xs)
            for _, _, xs in _taps(x.to(acc))]
    return torch.stack(taps, -1).view(dy.shape[1], x.shape[1], 3, 3)


def flip_weights(w: torch.Tensor) -> torch.Tensor:
    """Weights of the dX conv: rotate each 3x3 by 180 degrees and swap Ci
    and Co (`conv_gemm.py:101-103` in OIHW)."""
    return w.flip(2, 3).transpose(0, 1)


def _check(x: torch.Tensor, other: torch.Tensor, other_shape, co: int,
           what: str):
    if x.dim() != 4 or tuple(other.shape) != tuple(other_shape):
        raise ValueError(f"{what}: shapes {tuple(x.shape)} and "
                         f"{tuple(other.shape)}")
    if other.dtype != x.dtype or other.device != x.device:
        raise ValueError(f"{what}: dtypes / devices differ: {x.dtype} on "
                         f"{x.device}, {other.dtype} on {other.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: the kernel takes float32 or bfloat16, "
                         f"not {x.dtype}")
    n, ci, h, wd = x.shape
    if ci != C or co != C:
        raise ValueError(f"{what}: the kernel takes {C} channels in and out, "
                         f"not {ci} -> {co}")
    if not (1 <= wd <= MAX_WIDTH and h >= 1 and 1 <= n <= 65535):
        raise ValueError(f"{what}: unsupported size {tuple(x.shape)}")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{what}: the kernel takes contiguous tensors")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _nvcc.load("conv3x3")
    _nvcc.signature(lib.conv3x3_fwd, pointers=3, ints=9)
    _nvcc.signature(lib.conv3x3_dw_f32, pointers=4, ints=5)
    _nvcc.signature(lib.conv3x3_dw_bf16, pointers=4, ints=8)
    return lib


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = conv3x3(x, w): the CUDA kernel on the card, the plain version on
    the CPU. x (N, 64, H, W) and w (64, 64, 3, 3), contiguous, one dtype."""
    _check(x, w, (w.shape[0], x.shape[1], 3, 3), w.shape[0], "conv3x3_fwd")
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    n, _, h, wd = x.shape
    bf16 = x.dtype == torch.bfloat16
    blocking = (0,) * 5
    if bf16:  # (ky, kx, Co, Ci): rows of Ci for the kernel's 16-byte loads
        w = w.permute(2, 3, 0, 1).contiguous()
        geo = dw_rows_geometry(n, h, wd)
        blocking = (geo.strip, geo.rows, geo.units_per_block, geo.blocks,
                    dw_vector(wd, x))
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.conv3x3_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h,
                              wd, int(bf16), *blocking,
                              torch.cuda.current_stream().cuda_stream)
    _nvcc.check(lib, err, "conv3x3_fwd")
    conv3x3_fwd.launches += 1
    return y


def dw_geometry(n: int, h: int, w: int):
    """(tiles_per_chunk, chunks) of the f32 dW pixel loop: the N *
    ceil(HW / 64) tiles are cut into at most DW_MAX_CHUNKS runs of equal
    length, from the shape alone, so that the sum order is the same on
    every card."""
    tiles = n * -(-h * w // DW_TILE)
    per_chunk = -(-tiles // DW_MAX_CHUNKS)
    return per_chunk, -(-tiles // per_chunk)


class DwRows(NamedTuple):
    """The bf16 dW and forward kernels' blocking (`dw_rows_geometry`)."""
    strip: int            # columns per strip, a multiple of 8, <= DW_STRIP
    strips: int
    rows: int             # output rows per run
    runs: int             # runs per image
    units: int            # (image, strip, run) units, image-major
    units_per_block: int
    blocks: int           # = the partials dw_reduce sums (dW)


def dw_rows_geometry(n: int, h: int, w: int) -> DwRows:
    """The blocking of the bf16 dW and forward kernels, from the shape
    alone (the same sum order on every card): column strips of equal width (rounded up to 8,
    so that every strip starts on a 16-byte boundary), then runs of rows
    so that the units make about DW_BLOCKS blocks (one per image at
    B = 128), then consecutive units per block if there are more."""
    per_strip = -(-w // -(-w // DW_STRIP))
    strip = -(-per_strip // 8) * 8
    strips = -(-w // strip)
    runs = max(1, min(h, DW_BLOCKS // (n * strips)))
    rows = -(-h // runs)
    runs = -(-h // rows)
    units = n * strips * runs
    per_block = -(-units // DW_BLOCKS)
    return DwRows(strip, strips, rows, runs, units, per_block,
                  -(-units // per_block))


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def _round8(v: int) -> int:
    return -(-v // 8) * 8


def dw_row_stride(need: int) -> int:
    """Stride (elements) of a staged bf16 dW row of `need` elements: a
    multiple of 8 whose half is an odd multiple of 4, so that the rows of
    an mma fragment fall in distinct shared-memory banks."""
    return (need + 7) // 16 * 16 + 8


def dw_smem_bytes(w: int) -> int:
    """Shared memory of the bf16 dW kernel at width w: four x rows in two
    copies (DW_PAD + Wk + 8 columns) and two dY rows (Wk columns)."""
    wk = _round16(dw_rows_geometry(1, 1, w).strip)
    return C * 2 * (4 * 2 * dw_row_stride(wk + 2 * DW_PAD)
                    + 2 * dw_row_stride(wk))


def fwd_smem_bytes(w: int) -> int:
    """Shared memory of the bf16 forward kernel at width w: the resident
    weights [9][C][WS], X_SLOTS ring rows [Wk + 2][WS] and the landing row
    [C][DW_PAD + Wk + 8], Wk = the strip rounded up to 8."""
    wk = _round8(dw_rows_geometry(1, 1, w).strip)
    return 2 * (9 * C * WS + X_SLOTS * (wk + 2) * WS + C * (wk + 2 * DW_PAD))


def dw_vector(w: int, *tensors: torch.Tensor) -> int:
    """Elements per copy of the bf16 row staging, forward and dW (16, 8 or 4
    bytes, or 2 through registers): the most that divides the width and keeps every
    copy aligned in the given tensors."""
    return next(v for v in (8, 4, 2, 1) if w % v == 0 and all(
        t.data_ptr() % (2 * v) == 0 for t in tensors))


def conv3x3_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW (64, 64, 3, 3) f32 of conv3x3 at input x for output gradient dy:
    the CUDA kernel on the card (partials, then their sum in a fixed
    order), the plain version on the CPU."""
    _check(x, dy, (x.shape[0], dy.shape[1]) + tuple(x.shape[2:]),
           dy.shape[1], "conv3x3_dw")
    if x.device.type == "cpu":
        return conv3x3_dw_reference(x, dy)
    n, _, h, wd = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        geo = dw_rows_geometry(n, h, wd)
        blocks = geo.blocks
        args = (geo.strip, geo.rows, geo.units_per_block, blocks,
                dw_vector(wd, x, dy))
        launch = "conv3x3_dw_bf16"
    else:
        per_chunk, blocks = dw_geometry(n, h, wd)
        args = (per_chunk, blocks)
        launch = "conv3x3_dw_f32"
    partial = torch.empty((blocks, 9, C, C), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((C, C, 3, 3), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = getattr(lib, launch)(x.data_ptr(), dy.data_ptr(),
                                   partial.data_ptr(), dw.data_ptr(), n, h,
                                   wd, *args, stream)
    _nvcc.check(lib, err, "conv3x3_dw")
    conv3x3_dw.launches += 1
    return dw


conv3x3_fwd.launches = 0  # kernel launches since the last reset
conv3x3_dw.launches = 0


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return conv3x3_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_fwd(dy, flip_weights(w).contiguous())
        if ctx.needs_input_grad[1]:
            dw = conv3x3_dw(x, dy).to(w.dtype)
        return dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 conv with zero padding 1, no bias; differentiable in x
    and w. x and w in one dtype (autocast's casts are the caller's)."""
    return _Conv3x3.apply(x, w)
