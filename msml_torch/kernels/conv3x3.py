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

Design (simple first, see PERF.md for its times):
- forward: an implicit GEMM, M = output pixels, N = Co = 64, K = 9 Ci.
  One block owns 128 flattened pixels of one image and all 64 output
  channels. Per chunk of input channels it stages the image rows it needs,
  with a one-pixel halo and the zero padding, and the chunk's weights in
  shared memory, then loops over the 9 taps: bf16 on the tensor cores with
  `mma.sync.m16n8k16` (f32 accumulators), f32 in plain FFMA (no TF32).
  Loads run along W, as NCHW stores them; the bf16 epilogue goes through
  shared memory so that the stores run along the pixels too. What bounds
  this first kernel is the staging, not the tensor cores: one block waits
  on its own loads at each barrier. So the bf16 staging keeps 16 loads in
  flight per thread, puts two channels in each 32-bit shared word, and
  copies the weights (packed (ky, kx, Co, Ci) by the wrapper) with
  `cp.async` while the input rows load.
- dW: dW[co, ci, ky, kx] = sum over n, h, w of dy[n, co, h, w] *
  x[n, ci, h + ky - 1, w + kx - 1], a GEMM with K = N H W pixels. The TPU
  kernel added into its output across a sequential grid; Hopper's blocks
  run in no order, so block (tap, chunk) sums its chunk of 64-pixel tiles
  into an f32 (Co, Ci) partial, and a second, small launch sums the
  partials in chunk order: no atomics, the same bits on every run. Both
  launches are the one `conv3x3_dw` kernel and count as one launch.
Not yet: `wgmma`, TMA, a pipelined ring of stages, a persistent grid.

On a CPU tensor the wrappers run the plain versions, `conv3x3_reference`
and `conv3x3_dw_reference`: the sum over the nine taps of an `einsum` of
the shifted input, the TPU kernel's tap decomposition, in f32 (f64 for f64
inputs). On a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from msml_torch.kernels import _nvcc

C = 64                # the only channel count the kernels take
DW_TILE = 64          # pixels per dW tile (BK in csrc/conv3x3.cu)
DW_MAX_CHUNKS = 256   # dW partials at most (a chunk is a run of tiles)
MAX_WIDTH = 512       # the forward's staged rows fit in shared memory
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
    _nvcc.signature(lib.conv3x3_fwd, pointers=3, ints=4)
    _nvcc.signature(lib.conv3x3_dw, pointers=4, ints=6)
    return lib


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = conv3x3(x, w): the CUDA kernel on the card, the plain version on
    the CPU. x (N, 64, H, W) and w (64, 64, 3, 3), contiguous, one dtype."""
    _check(x, w, (w.shape[0], x.shape[1], 3, 3), w.shape[0], "conv3x3_fwd")
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    n, _, h, wd = x.shape
    bf16 = x.dtype == torch.bfloat16
    if bf16:  # (ky, kx, Co, Ci): rows of Ci for the kernel's 16-byte loads
        w = w.permute(2, 3, 0, 1).contiguous()
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.conv3x3_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h,
                              wd, int(bf16),
                              torch.cuda.current_stream().cuda_stream)
    _nvcc.check(lib, err, "conv3x3_fwd")
    conv3x3_fwd.launches += 1
    return y


def dw_geometry(n: int, h: int, w: int):
    """(tiles_per_chunk, chunks) of the dW pixel loop: the N * ceil(HW / 64)
    tiles are cut into at most DW_MAX_CHUNKS runs of equal length, from the
    shape alone, so that the sum order is the same on every card."""
    tiles = n * -(-h * w // DW_TILE)
    per_chunk = -(-tiles // DW_MAX_CHUNKS)
    return per_chunk, -(-tiles // per_chunk)


def conv3x3_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW (64, 64, 3, 3) f32 of conv3x3 at input x for output gradient dy:
    the CUDA kernel on the card (partials, then their sum in a fixed
    order), the plain version on the CPU."""
    _check(x, dy, (x.shape[0], dy.shape[1]) + tuple(x.shape[2:]),
           dy.shape[1], "conv3x3_dw")
    if x.device.type == "cpu":
        return conv3x3_dw_reference(x, dy)
    n, _, h, wd = x.shape
    per_chunk, chunks = dw_geometry(n, h, wd)
    partial = torch.empty((chunks, 9, C, C), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((C, C, 3, 3), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.conv3x3_dw(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                             dw.data_ptr(), n, h, wd, per_chunk, chunks,
                             int(x.dtype == torch.bfloat16),
                             torch.cuda.current_stream().cuda_stream)
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
