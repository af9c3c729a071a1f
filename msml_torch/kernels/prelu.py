"""Per-channel PReLU, forward and backward, as Triton kernels for Hopper.

Replaces the Pallas pair `benchmarks/negative/prelu_pallas.py`: `_fwd_kernel`
(launched by `_pallas_fwd`, `pallas_call` at :80) and `_bwd_kernel`
(`_pallas_bwd`, :101), tied together by the `jax.custom_vjp` at :122-136.
On NCHW `x` with an f32 slope `alpha` of shape (C,):

  forward   y  = where(x >= 0, x, alpha * x)              in x's dtype
  backward  dx = where(x < 0, g * alpha, g)               in x's dtype
            dalpha[c] = sum_{n,h,w} where(x < 0, g * x, 0) in f32

`alpha` is cast to x's dtype before it multiplies, as the flax module does
(`msml_tpu/nn/common.py:36-37`). At x == 0 the gradient is g: the JAX
convention (`jnp.where(x >= 0, ...)`), which `F.prelu` does not follow (its
backward gives alpha * g there).

Bound on the card: memory. The forward reads x and writes y; the backward
reads g and x and writes dx; each element costs one compare and one or two
multiplies. So the least time is 2 (forward) or 3 (backward) times the bytes
of x over the HBM rate.

Design. Both kernels cut the tensor per channel: a program owns one channel
c and a tile of (ROWS samples, BLOCK_HW pixels), so alpha[c] is one scalar
load per program and small planes (4 x 4, 7 x 7) still fill a tile. The
TPU kernel carried dalpha in VMEM across its sequential grid; Hopper's
blocks run in no order, so the backward writes one f32 partial per program
and a second, small launch sums each channel's partials in a fixed order:
no atomics, the result is the same on every run. Both launches are the one
`prelu_bwd` kernel and count as one launch.

`prelu(x, alpha)` is the `torch.autograd.Function`. Its two wrappers,
`prelu_fwd` and `prelu_bwd`, launch the Triton kernels for a CUDA tensor and
run the plain PyTorch versions for a CPU tensor; a failure to build or
launch raises. `prelu_reference` is the whole function written with
`torch.where`, differentiated by autograd.
"""

from __future__ import annotations

import functools
import os

import torch


_TRITON_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "triton")
_TILE = 2048  # elements per program (ROWS x BLOCK_HW)
_REDUCE_BLOCK = 1024  # partials summed per step of the reduction loop
_DTYPES = (torch.float32, torch.bfloat16)

tl = None  # triton.language, bound by _kernels() at the first launch


def prelu_reference(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch PReLU with the JAX gradient convention at x == 0."""
    a = _per_channel(alpha.to(x.dtype), x)
    return torch.where(x >= 0, x, a * x)


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.view((1, -1) + (1,) * (x.dim() - 2))


def prelu_bwd_reference(g: torch.Tensor, x: torch.Tensor,
                        alpha: torch.Tensor):
    """Plain PyTorch (dx, dalpha) of `prelu_reference`."""
    neg = x < 0
    dx = torch.where(neg, g * _per_channel(alpha.to(x.dtype), x), g)
    dims = [0] + list(range(2, x.dim()))
    da = torch.where(neg, g.float() * x.float(), 0.0).sum(dims)
    return dx, da


def _check(x: torch.Tensor, alpha: torch.Tensor) -> None:
    if x.dim() < 2 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be (N, C, ...) f32 or bf16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if alpha.dtype != torch.float32 or tuple(alpha.shape) != (x.shape[1],) \
            or alpha.device != x.device:
        raise ValueError(f"alpha must be float32 ({x.shape[1]},) on "
                         f"{x.device}, got {alpha.dtype} "
                         f"{tuple(alpha.shape)} on {alpha.device}")


def _geometry(x: torch.Tensor):
    """(N, C, HW, ROWS, BLOCK_HW, grid) of the per-channel tiling."""
    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    block_hw = min(_TILE, 1 << max(hw - 1, 1).bit_length())
    rows = _TILE // block_hw
    grid = (c, -(-n // rows), -(-hw // block_hw))
    return n, c, hw, rows, block_hw, grid


def prelu_fwd(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """y = where(x >= 0, x, alpha * x): the Triton kernel on CUDA, the plain
    version on the CPU."""
    _check(x, alpha)
    if x.device.type == "cpu":
        return prelu_reference(x, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    n, c, hw, rows, block_hw, grid = _geometry(x)
    fwd, _, _ = _kernels()
    with torch.cuda.device(x.device):
        fwd[grid](x, alpha, y, n, c, hw, ROWS=rows, BLOCK_HW=block_hw,
                  num_warps=4)
    prelu_fwd.launches += 1
    return y


def prelu_bwd(g: torch.Tensor, x: torch.Tensor, alpha: torch.Tensor):
    """(dx, dalpha) for the upstream gradient g: the Triton kernels on CUDA
    (one pass over g and x, then a per-channel sum of the partials), the
    plain version on the CPU."""
    _check(x, alpha)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("g must match x in shape, dtype and device")
    if x.device.type == "cpu":
        return prelu_bwd_reference(g, x, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    g, x = g.contiguous(), x.contiguous()
    dx = torch.empty_like(x)
    da = torch.zeros_like(alpha)
    if x.numel() == 0:
        return dx, da
    n, c, hw, rows, block_hw, grid = _geometry(x)
    parts = grid[1] * grid[2]
    partial = torch.empty((c, parts), dtype=torch.float32, device=x.device)
    _, bwd, reduce = _kernels()
    with torch.cuda.device(x.device):
        bwd[grid](g, x, alpha, dx, partial, n, c, hw, ROWS=rows,
                  BLOCK_HW=block_hw, num_warps=4)
        reduce[(c,)](partial, da, parts, BLOCK=_REDUCE_BLOCK, num_warps=4)
    prelu_bwd.launches += 1
    return dx, da


prelu_fwd.launches = 0  # kernel launches since the last reset
prelu_bwd.launches = 0


class _PReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x, alpha)
        return prelu_fwd(x, alpha)

    @staticmethod
    def backward(ctx, g):
        x, alpha = ctx.saved_tensors
        return prelu_bwd(g, x, alpha)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU over dim 1 of x (f32, or bf16 as autocast gives it,
    with no cast here), alpha f32 (C,); differentiable in both."""
    return _PReLU.apply(x, alpha)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Import Triton and JIT-decorate the three sources (first launch only);
    the build goes to `msml_torch/_build/triton` unless TRITON_CACHE_DIR is
    set."""
    global tl, _tile
    os.environ.setdefault("TRITON_CACHE_DIR", _TRITON_CACHE)
    import triton
    import triton.language as tl  # noqa: F811  (binds the module global)

    _tile = triton.jit(_tile)
    return (triton.jit(_prelu_fwd_kernel), triton.jit(_prelu_bwd_kernel),
            triton.jit(_prelu_reduce_kernel))


# ---------------------------------------------------------------- Triton
# The functions below are Triton sources; _kernels() decorates them.

def _tile(c, N, C, HW, ROWS: tl.constexpr, BLOCK_HW: tl.constexpr):
    """Offsets and mask of this program's (ROWS, BLOCK_HW) tile of channel
    c: rows are samples, columns pixels of the NCHW plane."""
    n = tl.program_id(1) * ROWS + tl.arange(0, ROWS)[:, None]
    p = tl.program_id(2) * BLOCK_HW + tl.arange(0, BLOCK_HW)[None, :]
    off = (n.to(tl.int64) * C + c) * HW + p
    return off, (n < N) & (p < HW)


def _prelu_fwd_kernel(x_ptr, a_ptr, y_ptr, N, C, HW, ROWS: tl.constexpr,
                      BLOCK_HW: tl.constexpr):
    c = tl.program_id(0)
    off, mask = _tile(c, N, C, HW, ROWS, BLOCK_HW)
    x = tl.load(x_ptr + off, mask=mask, other=0.0)
    a = tl.load(a_ptr + c).to(x.dtype)
    tl.store(y_ptr + off, tl.where(x >= 0, x, a * x), mask=mask)


def _prelu_bwd_kernel(g_ptr, x_ptr, a_ptr, dx_ptr, part_ptr, N, C, HW,
                      ROWS: tl.constexpr, BLOCK_HW: tl.constexpr):
    c = tl.program_id(0)
    off, mask = _tile(c, N, C, HW, ROWS, BLOCK_HW)
    g = tl.load(g_ptr + off, mask=mask, other=0.0)
    x = tl.load(x_ptr + off, mask=mask, other=0.0)
    a = tl.load(a_ptr + c).to(x.dtype)
    neg = x < 0  # masked lanes load x = 0: no contribution
    tl.store(dx_ptr + off, tl.where(neg, g * a, g), mask=mask)
    contrib = tl.where(neg, g.to(tl.float32) * x.to(tl.float32), 0.0)
    part = tl.sum(tl.sum(contrib, axis=1), axis=0)
    slot = tl.program_id(1) * tl.num_programs(2) + tl.program_id(2)
    tl.store(part_ptr + c * (tl.num_programs(1) * tl.num_programs(2))
             + slot, part)


def _prelu_reduce_kernel(part_ptr, da_ptr, PARTS, BLOCK: tl.constexpr):
    """One program per channel: dalpha[c] = the sum of its partials, in the
    same order on every run."""
    c = tl.program_id(0)
    acc = tl.zeros((BLOCK,), tl.float32)
    for start in range(0, PARTS, BLOCK):
        i = start + tl.arange(0, BLOCK)
        acc += tl.load(part_ptr + c * PARTS + i, mask=i < PARTS, other=0.0)
    tl.store(da_ptr + c, tl.sum(acc, axis=0))
