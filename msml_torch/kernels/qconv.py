"""int8 post-training quantization kernels for Hopper: the dynamic
per-sample activation quantizer and the int8 implicit-GEMM convolution.

No Pallas kernel of the JAX package has these as its counterpart: there
`msml_tpu/core/quantize.py` rewrites each eligible `conv_general_dilated`
and rank-2 `dot_general` of a traced forward to int8 and XLA lowers the
int8 ops (`:141-177`). PyTorch has no int8 convolution on CUDA, so the
port runs them here, as CUDA C++ for `sm_90a` (`csrc/qconv_int8.cu`):

  quant_act(x, cp)        x (N, C, H, W) or (N, C) float32 / bfloat16 ->
                          xq (N, H, W, cp) int8, channels last, channels
                          >= C zero; sx (N,) float32. sx = max(amax *
                          f32(1 / 127), 1e-12) with amax over each sample's
                          non-batch elements; xq = clip(rint(x / sx), +-127).
                          One launch: a thread-block cluster a sample
                          (`quant_act_plan`)
  qconv_int8(xq, wp, sx, sw, bias, geometry, out_dtype)
                          y (N, Co, Ho, Wo) = float32(conv(xq, w)) * (sx[n]
                          * sw[co]) in out_dtype (float32 or bfloat16), plus
                          the bias (Co,) if one is given: wp is
                          `pack_weight`'s layout
  pack_weight(wq, cp)     int8 (Co, Ci, KH, KW) -> (Co rounded up to 64,
                          KH * KW * cp), K ordered (ky, kx, ci)

`geometry` is (kh, kw, stride_h, stride_w, pad_h, pad_w, dil_h, dil_w,
out_h, out_w): the padding is that of the top and left of the input
dilated by (dil_h, dil_w) (the lhs dilation of a transposed conv, as XLA
lowers `lax.conv_transpose`), the bottom and right follow from the output
size. A transposed conv's weight is `transposed_as_conv`'s first.

The rounding is JAX's as its entry points run it (`jax.jit` of
`quantize_fn` on the CPU): XLA compiles `amax / 127` into a multiply by
the rounded reciprocal, and `x / sx` into an IEEE division, which the
kernel does with `__fdiv_rn` (Triton's fp32 `/` and `--use_fast_math` are
approximate and flip codes at ties), then `rintf`, half to even as
`jnp.round`. A float32 output's bias add is contracted with the
dequantizing multiply into one FMA, as XLA contracts flax's `y + bias`; a
bfloat16 output is rounded first and the bias added in bfloat16. The sums
are exact int32 on both sides, so the codes and the outputs are bit-equal
to the reference's.

Design:
- `quant_act`, design "v2": one launch, with no workspace, memset or
  atomic. The bound is bytes: x read once and xq written once. The first
  design read x twice (an abs-max pass, then the codes) and cost three
  graph nodes (a memset of the abs-max workspace and two kernels). JAX's
  scale is one per sample, so no code can be written before the maximum
  over the whole sample is known; v2 holds the sample on chip while it
  finds it. Its plan (`quant_act_plan`, Python, handed to the C entry
  point as int32s and tested on the CPU in
  tests/test_torch_quant_act_plan.py) gives each sample a thread-block
  cluster of K = 1, 2, 4, 8 or 16 blocks of 512 threads; block k owns
  pixels [k P, (k + 1) P) of every channel (P a multiple of 8), so its
  output xq[n, kP:(k+1)P, :] is one contiguous range. K is the least
  whose block fits 113 KB of shared memory (two blocks an SM), else the
  least that fits a block's 227 KB; K never exceeds the largest cluster
  the card places (`cluster_cap`, `cudaOccupancyMaxActiveClusters` on the
  card). At B = 512 in bf16: 64 x 112² takes K = 16, P = 784 (101,952 B a
  block); 64 x 56² K = 4; 64 x 28² and the smaller inputs K = 1 or 2;
  the fc's (N, 25,088) one block holding the sample flat.
  * Staging: a row (one channel's P pixels) is copied once by 16-byte
    `cp.async` of the aligned windows that cover it, the windows at its
    ends whole too: an aligned 16-byte window lies in one page with the
    row's bytes, and its other bytes are never read as data. So a row lies
    in shared memory at its global address modulo 16, and a 14² bf16
    plane of 392 B or a sample at an odd multiple of 4 B stages like an
    aligned one. A row is taken by a group of lanes, the least power of
    two that covers its windows (the flat sample by all threads). Copying
    a row's head and tail elements through registers instead made each
    row wait on global memory.
  * The maximum: each thread over the row bytes of the windows it copied
    (bf16 pairs by `__hmax2`, which like `fmaxf` drops a NaN), warp
    shuffles, the warps through shared memory, and with K > 1 each block's
    maximum read by every warp through distributed shared memory after one
    cluster barrier: the same maximum in any order, bit-equal to the
    first design's.
  * Codes: a warp builds 16 pixels x 32 channels, lane l one 16-byte
    piece (pixel l % 16, channels 16 (l / 16) ..) with one 16-byte store;
    each pair of lanes writes a whole 32-byte sector of xq. The two
    half-warps read channels 16 apart; each 16-channel group of rows
    starts 64 bytes after the previous one's end (a skew, not a pad of
    every row), so that the two 16-pixel runs fall 64 bytes apart modulo
    128: no bank conflict. Where every row of the block starts at one
    address modulo 16 (hw and P whole 16-byte multiples), channel j of a
    group lies j rows after its first; else a table of row offsets. The
    fc's flat row: thread g builds piece g, lane l reading channel 16 g +
    (j + r) % 16 at step j, r = l / 2 for float32 and 2 (l / 4) for bf16
    (32 distinct banks from any start modulo 16), and rotating the 16
    bytes back by r before its store.
  * The arithmetic: x / sx as IEEE division gives it, from y = RN(1 / sx)
    once a block, q = RN(x y) and one FMA (Markstein's correction), then
    the clip and rint by adding 1.5 2^23, whose low byte is the code: five
    FMA-pipe instructions. The first design's `__fdiv_rn`, `rintf` and
    `__float2int_rn` each take the 16-lane conversion pipe
    (`tools/quant_act_parts.py` times v2 with them, PERF.md).
  * A sample over 16 blocks' shared memory (a float32 64 x 128² is
    4.2 MB) keeps the first design's two passes, picked by shape (K = 0 in
    the plan); none of arc18_msml's 90 sites takes it, in bf16 or float32.
  Tried on the card and not kept (PERF.md): persistent clusters
  that walk the samples, with one buffer or two (staging sample i + 1
  while coding sample i, one block an SM), neither faster. What bounds v2
  at the large inputs is not the bytes: a cluster's blocks go through
  load, maximum, barrier and codes in step, two blocks an SM
  (`tools/quant_act_parts.py`, PERF.md). The kernel, `act_cluster`
  (`-Xptxas -v` on the H100's nvcc 12.9; launch bounds 512 threads, 2
  blocks an SM, so at most 64 registers): registers, shared memory and
  clusters resident per instance are in PERF.md (`chip_smoke.py` phase 1
  prints them).
- `qconv_int8`, design "v2": a GEMM with M = Co, N = the batch's output
  pixels and K = the taps x cp (cp = C rounded up to 32), on
  `mma.sync.m16n8k32.s8.s8.s32`, one launch per call. Its plan
  (`qconv_plan`, in Python, handed to the C entry point as int32s and
  tested on the CPU in tests/test_torch_qconv_plan.py) fixes:
  * phases: a transposed conv runs lhs-dilated (dil 2 here), where three
    of every four taps of a 4 x 4 kernel fall in a hole. Its outputs split
    by residue modulo the period dil / gcd(stride, dil) into phases
    (`grid` over them, one launch); each phase is a plain conv over the
    undilated input that walks only the taps landing on input rows and
    columns (4 of 16 for the 4 x 4 deconvs, 1-4 of 9 for the 3 x 3 one),
    masked where ho or wo is odd and the phases differ in size. No hole is
    loaded or multiplied. A conv without dilation is one phase.
  * the tile, a template instance picked by the C entry point: bm = 32
    output channels for Co <= 32 (rows 0..31 of the 64-row packing; 18 of
    32 rows are real at the Co = 18 sites, against 18 of 64 before), 128
    where the packing's rows are a multiple of 128, else 64; bn = 256
    pixels (bm = 64 only), 128 or 64, the widest that still gives 8, 4 or
    2 blocks per SM. A warp owns (32 or 64) x (32 or 64) of the tile.
  * split K: a launch of fewer blocks than SMs over at least 64 stages of
    K (the fc: K = 25,088, B = 512, 32 tiles) splits K into slices of about
    two blocks per SM in all (9 at B = 512). Each block adds its int32
    partial sums into a workspace the wrapper allocates and the C entry
    point zeroes, by `atomicAdd`; the last block of a tile to arrive (an
    arrival count) reads the sums back and runs the epilogue. int32
    addition is exact, so the output is the same in any order.
  A block stages 64 bytes of K a stage (two k32 steps) through a ring of
  4 stages of `cp.async` with zero fill (padding, past the phase's K).
  Each thread copies one 16-byte piece of each of its A and B rows; since
  cp is a multiple of 32 a piece never straddles a tap, and its (tap,
  channel) advances by additions (no division in the loop). A shared row
  is 64 bytes with its 16-byte chunks XOR-swizzled by (row / 2) % 4, so
  that the stores and the `ldmatrix.x4` loads meet no bank conflict: the
  int8 m16n8k32 A and B fragments are b16 8 x 8 matrices of 16-byte K
  rows, four to an `ldmatrix.x4`. The epilogue dequantizes in registers
  (`__int2float_rn(acc) * __fmul_rn(sx[n], sw[co])`, an FMA with the bias
  for float32, the bias added after rounding for bfloat16), writes the
  tile to shared memory over the ring, and stores each channel's runs of
  pixels as 16-byte vectors where Ho Wo is a multiple of the vector (8
  bfloat16 or 4 float32), else one element a thread along the pixels
  (along the channels for the fc's (N, Co)). Each output pixel's (n,
  offsets) are computed once per block, in a table in shared memory.
  Instances (`-Xptxas -v` on the H100's nvcc 12.9, both output dtypes;
  no spill; dynamic shared memory, over 48 KB by `cudaFuncSetAttribute`;
  blocks per SM by registers and shared memory):

  | bm x bn | threads | warp tile | registers | shared memory | blocks / SM |
  |---|---|---|---|---|---|
  | 32 x 64 | 64 | 32 x 32 | 107 | 26,128 B | 8 |
  | 32 x 128 | 128 | 32 x 32 | 107 | 44,048 B | 4 |
  | 64 x 64 | 128 | 32 x 32 | 101 | 34,320 B | 4 |
  | 64 x 128 | 256 | 32 x 32 | 95 | 52,240 B | 2 |
  | 64 x 256 | 256 | 32 x 64 | 126 | 88,080 B | 2 |
  | 128 x 64 | 128 | 64 x 32 | 123 | 50,704 B | 4 |
  | 128 x 128 | 256 | 64 x 32 | 125 | 68,624 / 72,720 B | 2 |

  What bounds it: at B = 512, 50 of arc18_msml's 68 geometries are
  bound by bytes (the int8 codes in, the bf16 output out: at the 112²
  conv 411 MB and 822 MB), the 18 3 x 3 convs of 128 channels or more in
  and out by int8 operations. The design reads each input byte once per tap from
  L2 and writes each output once, coalesced; what it does not yet have:
  `wgmma` and TMA, and reuse of a staged input row across the taps
  (PERF.md). `quant_act` cannot be folded into the previous op's epilogue
  and keep JAX's bits: the scale is one per sample, so no code can be
  written until the maximum over the whole sample is known, and the fold
  would still read its input twice.

On a CPU tensor the wrappers run the plain versions, `quant_act_reference`
and `qconv_reference` (F.conv2d on the int8 values as float64: every int32
sum here is below 2^53, so it is exact); on a CUDA tensor they launch the
kernel or raise. Both are custom ops (`msml_torch::quant_act`,
`msml_torch::qconv_int8`, with fake implementations), so that an exported
program (`tools/export_serving.py --quant int8`) runs the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from msml_torch.kernels import _nvcc

QMAX = 127.0   # symmetric int8 range (msml_tpu/core/quantize.py:56)
EPS = 1e-12    # floor of every scale (:59)
# f32(1 / 127): what XLA multiplies by for the reference's `amax / 127`
INV_QMAX = float(np.float32(1.0) / np.float32(QMAX))
CP_ALIGN = 32  # channel padding of xq: one mma k32 step per tap
W_ROWS = 64    # wp's rows (output channels) are padded to a multiple of it
BK = 64        # K bytes of one stage of the conv kernel: two mma k32 steps
TILES = ((32, 64), (32, 128), (64, 64), (64, 128), (64, 256), (128, 64),
         (128, 128))  # (bm, bn) of the kernel's template instances
MAX_PHASES = 64  # phases of one launch: dil_h * dil_w at most
SMS = 132      # streaming multiprocessors of the H100
# quant_act's cluster route (csrc/qconv_int8.cu: CT, SKEW, SCRATCH)
ACT_THREADS = 512
ACT_SKEW = 64     # bytes between two 16-channel groups' rows
ACT_SCRATCH = 128  # bytes after the staged data: the warps' and the block's
                   # maxima
CLUSTER_SIZES = (1, 2, 4, 8, 16)
SMEM_BLOCK = 232448  # an H100 block's opt-in shared memory (227 KB)
SMEM_PAIR = 115712   # each of two blocks on one SM: (228 KB) / 2 less the
                     # 1 KB the card reserves a block
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def padded_channels(c: int) -> int:
    """Channels of xq for C input channels: C rounded up to 32."""
    return -(-c // CP_ALIGN) * CP_ALIGN


def conv_out_size(size: int, k: int, stride: int, pad_lo: int, pad_hi: int,
                  dil: int = 1) -> int:
    """Output length of a conv over an input of `size` dilated by `dil`."""
    return ((size - 1) * dil + 1 + pad_lo + pad_hi - k) // stride + 1


def _as_nchw(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        return x[:, :, None, None]
    if x.dim() != 4:
        raise ValueError(f"quant_act takes (N, C, H, W) or (N, C), not "
                         f"{tuple(x.shape)}")
    return x


def act_scale_reference(x: torch.Tensor) -> torch.Tensor:
    """sx (N,) float32 of x (N, ...): max(amax * f32(1/127), 1e-12)."""
    amax = x.float().abs().flatten(1).amax(1)
    return torch.clamp_min(amax * INV_QMAX, EPS)


def quant_act_reference(x: torch.Tensor, cp: int):
    """Plain `quant_act`: (xq (N, H, W, cp) int8, sx (N,) float32)."""
    xf = _as_nchw(x).float()
    sx = act_scale_reference(xf)
    # a divisor tensor on x's device: torch divides by a CPU scalar as a
    # multiply by its reciprocal on the card
    q = torch.round(xf / sx[:, None, None, None]).clamp_(-QMAX, QMAX)
    q = q.to(torch.int8).permute(0, 2, 3, 1)
    return F.pad(q, (0, cp - q.shape[-1])).contiguous(), sx


def quant_weight(w: torch.Tensor, out_axis: int = 0,
                 reciprocal: bool = False):
    """Symmetric per-output-channel int8 of w (`_quant_weight`, :85-108):
    (wq int8, sw float32 (w.shape[out_axis],)), on the CPU. The scale is
    amax / 127 by IEEE division, as the reference's numpy path computes it
    for a weight it finds as a constant; `reciprocal` gives amax * f32(1 /
    127), as XLA computes it where the reference's jitted forward casts the
    weight first (a bf16 op on float32 parameters), which makes the weight
    a traced value."""
    wf = w.detach().to("cpu", torch.float32)
    axes = [d for d in range(wf.dim()) if d != out_axis]
    shape = [1] * wf.dim()
    shape[out_axis] = -1
    amax = wf.abs().amax(dim=axes)
    sw = torch.clamp_min(amax * INV_QMAX if reciprocal else amax / QMAX, EPS)
    wq = torch.round(wf / sw.view(shape)).clamp_(-QMAX, QMAX)
    return wq.to(torch.int8), sw


def transposed_as_conv(w: torch.Tensor) -> torch.Tensor:
    """The conv weight (Co, Ci, KH, KW) of a transposed conv's (Ci, Co, KH,
    KW): in and out swapped, each kernel rotated by 180 degrees
    (`lax.conv_transpose(..., transpose_kernel=True)`)."""
    return w.transpose(0, 1).flip(2, 3)


def pack_weight(wq: torch.Tensor, cp: int) -> torch.Tensor:
    """int8 (Co, Ci, KH, KW) -> (Co rounded up to 64, KH * KW * cp): row co
    holds taps (ky, kx) in order, each the Ci codes then zeros to cp."""
    co, ci, kh, kw = wq.shape
    w = F.pad(wq.permute(0, 2, 3, 1), (0, cp - ci))
    w = w.reshape(co, kh * kw * cp)
    return F.pad(w, (0, 0, 0, -(-co // W_ROWS) * W_ROWS - co)).contiguous()


def unpack_weight(wp: torch.Tensor, co: int, kh: int, kw: int
                  ) -> torch.Tensor:
    """`pack_weight`'s inverse up to the channel padding: (Co, cp, KH, KW)."""
    return wp[:co].view(co, kh, kw, -1).permute(0, 3, 1, 2)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """a * b + c for float32 tensors with one rounding, as `fmaf`. The
    product of two float32 values is exact in float64; the float64 sum s
    carries its error e (TwoSum), which decides the one case where
    rounding s to float32 differs from rounding s + e: s on a midpoint of
    the float32 grid."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    v = s - p
    e = (p - (s - v)) + (c - v)
    y = s.float()
    toward = torch.where(s > y.double(), torch.inf, -torch.inf).float()
    mid = (y.double() + torch.nextafter(y, toward).double()) / 2
    nudged = torch.nextafter(s, torch.where(e > 0, torch.inf, -torch.inf)
                             .double()).float()
    return torch.where((s == mid) & (e != 0), nudged, y)


def qconv_reference(xq: torch.Tensor, wp: torch.Tensor, sx: torch.Tensor,
                    sw: torch.Tensor, bias: Optional[torch.Tensor],
                    geometry: Sequence[int], out_dtype: torch.dtype
                    ) -> torch.Tensor:
    """Plain `qconv_int8`: the input dilated and padded explicitly, then
    F.conv2d in float64 (exact), then the dequantization and the bias."""
    kh, kw, sh, swd, ph, pw, dh, dw, ho, wo = geometry
    n, h, w, _ = xq.shape
    x = xq.permute(0, 3, 1, 2).double()
    if dh > 1 or dw > 1:
        xd = x.new_zeros(x.shape[:2] + ((h - 1) * dh + 1, (w - 1) * dw + 1))
        xd[:, :, ::dh, ::dw] = x
        x = xd
    pb = (ho - 1) * sh + kh - x.shape[2] - ph
    pr = (wo - 1) * swd + kw - x.shape[3] - pw
    x = F.pad(x, (pw, pr, ph, pb))
    weight = unpack_weight(wp, sw.shape[0], kh, kw).double()
    # cuDNN's transform algorithms would round; the native conv is im2col
    # and a float64 GEMM, exact on these integers
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x, weight, stride=(sh, swd))
    return dequantize(acc, sx, sw, bias, out_dtype)


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
               bias: Optional[torch.Tensor], out_dtype: torch.dtype
               ) -> torch.Tensor:
    """float32(acc) * (sx[n] * sw[co]) (+ bias) in out_dtype, as the kernel
    rounds it, of exact sums acc (N, Co, Ho, Wo) held in any dtype."""
    acc = acc.to(torch.float32)
    scale = sx[:, None, None, None] * sw[None, :, None, None]
    if bias is None:
        return (acc * scale).to(out_dtype)
    b = bias[None, :, None, None].expand_as(acc)
    if out_dtype == torch.float32:
        return fma_f32(acc, scale.expand_as(acc), b)
    return ((acc * scale).to(out_dtype).float() + b).to(out_dtype)


class Phase(NamedTuple):
    """Outputs (ry + ty jy, rx + tx jx) for jy < ho, jx < wo of a conv
    with period (ty, tx) and input step (sy, sx) (`QConvPlan`): output
    (jy, jx) reads input (iy0 + sy jy + i, ix0 + sx jx + j) with the
    weight's tap (ky0 + dil_h i, kx0 + dil_w j), i < nky, j < nkx."""
    ry: int
    rx: int
    ky0: int
    kx0: int
    nky: int
    nkx: int
    iy0: int
    ix0: int
    ho: int
    wo: int


class QConvPlan(NamedTuple):
    """What `qconv_int8`'s kernel is launched with (`qconv_plan`)."""
    bm: int          # output channels of a block (its template instance)
    bn: int          # output pixels of a block
    splits: int      # K slices (blockIdx.z), each of kt_per stages of BK
    kt_per: int
    period: Tuple[int, int]  # (ty, tx)
    step: Tuple[int, int]    # (sy, sx)
    ntm: int         # channel tiles
    ntp: int         # pixel tiles (of the largest phase)
    phases: Tuple[Phase, ...]

    @property
    def blocks(self) -> int:
        """Blocks of one K slice: a (channel tile, phase, pixel tile)
        each."""
        return self.ntm * len(self.phases) * self.ntp

    @property
    def workspace(self) -> int:
        """int32 elements of the split-K workspace: each block's partial
        sums and an arrival count (0 without a split)."""
        return self.blocks * (self.bm * self.bn + 1) if self.splits > 1 \
            else 0

    def array(self) -> np.ndarray:
        """The C entry point's int32 plan: bm, bn, splits, kt_per, ty, tx,
        sy, sx, phases, ntm, ntp, then each phase's ten fields."""
        head = (self.bm, self.bn, self.splits, self.kt_per, *self.period,
                *self.step, len(self.phases), self.ntm, self.ntp)
        return np.array(head + sum(self.phases, ()), dtype=np.int32)


def _axis_phases(k: int, stride: int, pad: int, dil: int, out: int):
    """(period, step, [(r, k0, nk, i0, outputs)]) along one axis: output
    o = r + period j reads the input dilated by `dil` at o stride - pad + t
    for the taps t; the taps that land on an input element are t = k0 + dil
    i (i < nk), at input element i0 + step j + i."""
    g = math.gcd(stride, dil)
    period, step = dil // g, stride // g
    out_phases = []
    for r in range(min(period, out)):
        k0 = (pad - r * stride) % dil
        nk = 0 if k0 >= k else (k - 1 - k0) // dil + 1
        out_phases.append((r, k0, nk, (r * stride - pad + k0) // dil,
                           -(-(out - r) // period)))
    return period, step, out_phases


def qconv_plan(n: int, cp: int, co: int, geometry: Sequence[int]
               ) -> QConvPlan:
    """The launch plan of `qconv_int8` for a batch of n, cp input channels
    (padded), co output channels and `geometry`.

    Phases: an lhs-dilated conv (a transposed conv's, dil > 1) splits its
    outputs by their residue modulo the period dil / gcd(stride, dil); each
    phase is a plain conv over the undilated input with step stride / gcd,
    over only the taps that land on input rows and columns (no hole is
    loaded or multiplied). A conv without dilation is one phase. Tile: bm =
    32 channels for co <= 32 (rows 0..31 of the 64-row packing), 128 where
    the packing's rows are a multiple of 128, else 64; bn = 256 pixels
    (with bm = 64) or 128 where that still gives 8 or 4 blocks per SM,
    else 64. Split K: a launch of fewer blocks than SMs over at least 64
    stages of K (the fc) splits each phase's stages into slices of kt_per,
    about two blocks per SM in all."""
    kh, kw, sh, swd, ph, pw, dh, dw, ho, wo = geometry
    ty, sy, rows = _axis_phases(kh, sh, ph, dh, ho)
    tx, sx, cols = _axis_phases(kw, swd, pw, dw, wo)
    phases = tuple(Phase(ry, rx, ky0, kx0, nky, nkx, iy0, ix0, hp, wp_)
                   for ry, ky0, nky, iy0, hp in rows
                   for rx, kx0, nkx, ix0, wp_ in cols)
    co_pad = -(-co // W_ROWS) * W_ROWS
    bm = 32 if co <= 32 else 128 if co_pad % 128 == 0 else 64
    ntm = -(-co // bm)
    pixels = n * max(f.ho * f.wo for f in phases)
    bn = next(b for b in (256, 128, 64) if (bm, b) in TILES and (
        b == 64 or ntm * len(phases) * -(-pixels // b) >= SMS * b // 32))
    ntp = -(-pixels // bn)
    kt = max(-(-f.nky * f.nkx * cp // BK) for f in phases)
    splits, kt_per = 1, max(kt, 1)
    blocks = ntm * len(phases) * ntp
    if blocks < SMS and kt >= 64:
        kt_per = -(-kt // min(-(-2 * SMS // blocks), kt // 16))
        splits = -(-kt // kt_per)
    return QConvPlan(bm, bn, splits, kt_per, (ty, tx), (sy, sx), ntm, ntp,
                     phases)


class ActPlan(NamedTuple):
    """What `quant_act`'s kernel is launched with (`quant_act_plan`)."""
    k: int      # blocks of a sample's cluster; 0: the two-pass route
    p: int      # pixels a block owns
    rowb: int   # bytes of a staged channel row (0: the flat layout, hw = 1)
    smem: int   # dynamic shared memory of a block

    @property
    def route(self) -> str:
        return "cluster" if self.k else "two-pass"

    def array(self) -> np.ndarray:
        """The C entry point's int32 plan: k, p, rowb, smem."""
        return np.array(self, dtype=np.int32)


TWO_PASS = ActPlan(0, 0, 0, 0)


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def act_smem(c: int, hw: int, rowb: int, esize: int) -> int:
    """Bytes of a cluster block's shared memory (the kernel's `act_smem`).
    hw = 1: the sample's c elements at their global address modulo 16.
    Else c rows of rowb bytes, row ch at ch rowb + ACT_SKEW (ch // 16) (a
    16-channel group ACT_SKEW bytes after the previous one), each holding
    the block's pixels at their global address modulo 16, then an int
    offset a row. Then ACT_SCRATCH."""
    if hw == 1:
        return _round16(c * esize) + 16 + ACT_SCRATCH
    return (c * rowb + ACT_SKEW * ((c - 1) // 16) + _round16(4 * c)
            + ACT_SCRATCH)


def quant_act_plan(n: int, c: int, hw: int, esize: int,
                   cap: int = CLUSTER_SIZES[-1]) -> ActPlan:
    """`quant_act`'s plan for n samples of c channels x hw pixels of esize
    bytes, with clusters of at most `cap` blocks (`cluster_cap`).

    hw = 1 (the fc): one block, the sample flat. Else the least K whose
    block (P = hw, or ceil(hw / K) rounded up to 8, pixels of each channel
    in rows of P esize rounded up to 16, plus 16 for a start anywhere
    modulo 16) fits SMEM_PAIR, else the least that fits SMEM_BLOCK. A
    sample that fits neither takes the two-pass route."""
    if n < 1 or n > 65535:
        raise ValueError(f"quant_act: batch of {n} (1 .. 65535)")
    if hw == 1:
        smem = act_smem(c, 1, 0, esize)
        return ActPlan(1, 1, 0, smem) if smem <= SMEM_BLOCK else TWO_PASS
    for budget in (SMEM_PAIR, SMEM_BLOCK):
        for k in CLUSTER_SIZES:
            if k > cap:
                break
            p = hw if k == 1 else -(-(-(-hw // k)) // 8) * 8
            rowb = _round16(p * esize) + 16
            smem = act_smem(c, hw, rowb, esize)
            if smem <= budget:
                return ActPlan(k, p, rowb, smem)
    return TWO_PASS


def describe_act_plan(plan: ActPlan) -> str:
    """One line: route, cluster, pixels and shared memory of a block."""
    if plan.k == 0:
        return "two-pass (act_amax + act_quant)"
    return (f"cluster of {plan.k}, {plan.p} pixel{'s' if plan.p > 1 else ''}"
            f" a block{' (flat)' if plan.rowb == 0 else ''}, {plan.smem} B")


def _landing(size: int, k: int, stride: int, pad: int, dil: int,
             out: int) -> np.ndarray:
    """The input element of each (output position, tap) pair along one
    axis that lands on one (not padding, not a dilation hole)."""
    v = np.arange(out)[:, None] * stride - pad + np.arange(k)[None, :]
    return v[(v >= 0) & (v % dil == 0) & (v // dil < size)] // dil


def site_work(n: int, shape: Sequence[int], geometry: Sequence[int],
              co: int, out_bytes: int) -> Tuple[int, int, int]:
    """What an int8 site at batch n must do, for its bounds: (int8
    operations, 2 per real multiply-add (no padding, no dilation holes);
    bytes `qconv_int8` must move (the pixels of xq that some tap lands on
    and the packed weight read once, y written once, the scales); bytes
    `quant_act` must move (x read once, xq written once, sx), which is
    what its cluster route moves: it reads each input byte once). shape
    is the input less the batch, (C, H, W) or (C,)."""
    ci, h, w = (shape[0], 1, 1) if len(shape) == 1 else shape
    kh, kw, sh, swd, ph, pw, dh, dw, ho, wo = geometry
    cp = padded_channels(ci)
    rows, cols = (_landing(h, kh, sh, ph, dh, ho),
                  _landing(w, kw, swd, pw, dw, wo))
    ops = 2 * n * co * ci * rows.size * cols.size
    xq = n * h * w * cp
    conv = n * np.unique(rows).size * np.unique(cols).size * cp \
        + -(-co // W_ROWS) * W_ROWS * kh * kw * cp \
        + n * co * ho * wo * out_bytes + 4 * (n + 2 * co)
    return ops, int(conv), n * ci * h * w * out_bytes + xq + 4 * n


def describe_plan(plan: QConvPlan) -> str:
    """One line: tile, phases with their taps, split K, blocks."""
    taps = sorted({f.nky * f.nkx for f in plan.phases})
    return (f"tile {plan.bm}x{plan.bn}, {len(plan.phases)} phase"
            f"{'s' if len(plan.phases) > 1 else ''} of "
            f"{'/'.join(map(str, taps))} tap{'s' if taps[-1] > 1 else ''}, "
            f"split K "
            f"{plan.splits} x {plan.kt_per} stages, "
            f"{plan.blocks * plan.splits} blocks")


@functools.lru_cache(maxsize=4096)
def _plan_args(n: int, cp: int, co: int, geometry: Tuple[int, ...]):
    """The plan and its int32 array, once a shape (the wrapper's host
    time)."""
    plan = qconv_plan(n, cp, co, geometry)
    if len(plan.phases) > MAX_PHASES:
        raise ValueError(f"qconv_int8: {len(plan.phases)} phases of "
                         f"geometry {geometry} (at most {MAX_PHASES})")
    return plan, plan.array()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _nvcc.load("qconv_int8")
    _nvcc.signature(lib.quant_act, pointers=5, ints=5)
    _nvcc.signature(lib.qconv_int8, pointers=8, ints=16)
    lib.quant_act_occupancy.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.quant_act_occupancy.restype = ctypes.c_int
    return lib


def act_occupancy(bf16: bool, k: int, smem: int) -> Tuple[int, int]:
    """(clusters of k blocks of `smem` bytes the card holds at once, such
    blocks an SM holds) for the bf16 or float32 instance, on the current
    device."""
    lib = _lib()
    clusters, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.quant_act_occupancy(int(bf16), k, smem,
                                  ctypes.byref(clusters),
                                  ctypes.byref(per_sm))
    _nvcc.check(lib, err, "quant_act_occupancy")
    return clusters.value, per_sm.value


@functools.lru_cache(maxsize=None)
def cluster_cap(device_index: int, bf16: bool) -> int:
    """The largest cluster size the card places with a whole block's
    shared memory (SMEM_BLOCK) in each block: queried once a device."""
    with torch.cuda.device(device_index):
        for k in reversed(CLUSTER_SIZES):
            if act_occupancy(bf16, k, SMEM_BLOCK)[0] >= 1:
                return k
    raise RuntimeError("quant_act: the card places no cluster of one "
                       f"block with {SMEM_BLOCK} B of shared memory")


@functools.lru_cache(maxsize=4096)
def _act_plan_args(n: int, c: int, hw: int, esize: int, cap: int):
    """The plan and its int32 array, once a shape."""
    plan = quant_act_plan(n, c, hw, esize, cap)
    return plan, plan.array()


def _device_of(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def quant_act(x: torch.Tensor, cp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq, sx) of x (N, C, H, W) or (N, C): the CUDA kernel on the card,
    the plain version on the CPU; cp = `padded_channels(C)`.

    The custom op `torch.ops.msml_torch.quant_act`."""
    _device_of(x, "quant_act")
    return torch.ops.msml_torch.quant_act(x, cp)


def _check_act(x: torch.Tensor, cp: int) -> None:
    x = _as_nchw(x)
    if not x.is_floating_point() or cp % CP_ALIGN or cp < x.shape[1]:
        raise ValueError(f"quant_act: {x.dtype} input, {x.shape[1]} "
                         f"channels padded to {cp}")


@torch.library.custom_op("msml_torch::quant_act", mutates_args=(),
                         device_types="cpu")
def _quant_act_op(x: torch.Tensor, cp: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_act(x, cp)
    return quant_act_reference(x, cp)


@_quant_act_op.register_kernel("cuda")
def _quant_act_cuda(x: torch.Tensor, cp: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_act(x, cp)
    if x.dtype not in _OUT_DTYPES:
        raise ValueError(f"quant_act: the kernel takes float32 or bfloat16, "
                         f"not {x.dtype}")
    x4 = _as_nchw(x).contiguous()
    n, c, h, w = x4.shape
    bf16 = x.dtype == torch.bfloat16
    plan, args = _act_plan_args(n, c, h * w, x.element_size(),
                                cluster_cap(x.device.index, bf16))
    xq = torch.empty((n, h, w, cp), dtype=torch.int8, device=x.device)
    sx = torch.empty((n,), dtype=torch.float32, device=x.device)
    amax = (torch.empty((n,), dtype=torch.int32, device=x.device)
            if plan.k == 0 else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.quant_act(x4.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                            None if amax is None else amax.data_ptr(),
                            args.ctypes.data, n, c, h * w, cp, int(bf16),
                            torch.cuda.current_stream().cuda_stream)
    _nvcc.check(lib, err, "quant_act")
    quant_act.launches += 1
    return xq, sx


@_quant_act_op.register_fake
def _quant_act_fake(x: torch.Tensor, cp: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    x4 = _as_nchw(x)
    n, _, h, w = x4.shape
    return (x.new_empty((n, h, w, cp), dtype=torch.int8),
            x.new_empty((n,), dtype=torch.float32))


def qconv_int8(xq: torch.Tensor, wp: torch.Tensor, sx: torch.Tensor,
               sw: torch.Tensor, bias: Optional[torch.Tensor],
               geometry: Sequence[int], out_dtype: torch.dtype
               ) -> torch.Tensor:
    """y (N, Co, Ho, Wo) in out_dtype: the CUDA kernel on the card, the
    plain version on the CPU; bias float32 (Co,) or None. The custom op
    `torch.ops.msml_torch.qconv_int8`."""
    _device_of(xq, "qconv_int8")
    return torch.ops.msml_torch.qconv_int8(xq, wp, sx, sw, bias,
                                           list(geometry), out_dtype)


def _check_conv(xq, wp, sx, sw, bias, geometry, out_dtype) -> None:
    if len(geometry) != 10:
        raise ValueError(f"qconv_int8: geometry {geometry}")
    kh, kw, sh, swd, ph, pw, dh, dw, ho, wo = geometry
    n, _, _, cp = xq.shape
    co = sw.shape[0]
    if (xq.dtype != torch.int8 or wp.dtype != torch.int8
            or sx.dtype != torch.float32 or sw.dtype != torch.float32
            or out_dtype not in _OUT_DTYPES):
        raise ValueError(f"qconv_int8: dtypes {xq.dtype}, {wp.dtype}, "
                         f"{sx.dtype}, {sw.dtype} -> {out_dtype}")
    if (cp % CP_ALIGN or tuple(wp.shape) != (-(-co // W_ROWS) * W_ROWS,
                                              kh * kw * cp)
            or tuple(sx.shape) != (n,) or min(sh, swd, dh, dw, ho, wo) < 1
            or min(ph, pw) < 0):
        raise ValueError(f"qconv_int8: xq {tuple(xq.shape)}, wp "
                         f"{tuple(wp.shape)}, sx {tuple(sx.shape)}, sw "
                         f"{tuple(sw.shape)}, geometry {geometry}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (co,)):
        raise ValueError(f"qconv_int8: bias {bias.dtype} "
                         f"{tuple(bias.shape)} for {co} channels")
    devices = {t.device for t in (xq, wp, sx, sw, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"qconv_int8: tensors on {devices}")


@torch.library.custom_op("msml_torch::qconv_int8", mutates_args=(),
                         device_types="cpu")
def _qconv_op(xq: torch.Tensor, wp: torch.Tensor, sx: torch.Tensor,
              sw: torch.Tensor, bias: Optional[torch.Tensor],
              geometry: Sequence[int], out_dtype: torch.dtype
              ) -> torch.Tensor:
    _check_conv(xq, wp, sx, sw, bias, geometry, out_dtype)
    return qconv_reference(xq, wp, sx, sw, bias, geometry,
                           out_dtype).contiguous()


@_qconv_op.register_kernel("cuda")
def _qconv_cuda(xq: torch.Tensor, wp: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, bias: Optional[torch.Tensor],
                geometry: Sequence[int], out_dtype: torch.dtype
                ) -> torch.Tensor:
    _check_conv(xq, wp, sx, sw, bias, geometry, out_dtype)
    if not all(t.is_contiguous() for t in (xq, wp, sx, sw, bias)
               if t is not None):
        raise ValueError("qconv_int8: the kernel takes contiguous tensors")
    if xq.data_ptr() % 16 or wp.data_ptr() % 16:
        raise ValueError("qconv_int8: xq and wp must be 16-byte aligned")
    kh, kw, sh, swd, ph, pw, dh, dw, ho, wo = geometry
    n, h, w, cp = xq.shape
    co = sw.shape[0]
    plan, args = _plan_args(n, cp, co, tuple(geometry))
    y = torch.empty((n, co, ho, wo), dtype=out_dtype, device=xq.device)
    ws = (torch.empty((plan.workspace,), dtype=torch.int32,
                      device=xq.device) if plan.splits > 1 else None)
    lib = _lib()
    with torch.cuda.device(xq.device):
        err = lib.qconv_int8(xq.data_ptr(), wp.data_ptr(), sx.data_ptr(),
                             sw.data_ptr(),
                             None if bias is None else bias.data_ptr(),
                             y.data_ptr(),
                             None if ws is None else ws.data_ptr(),
                             args.ctypes.data, n, h, w, cp, co,
                             ho, wo, kh, kw, sh, swd, ph, pw, dh, dw,
                             int(out_dtype == torch.bfloat16),
                             torch.cuda.current_stream().cuda_stream)
    _nvcc.check(lib, err, "qconv_int8")
    qconv_int8.launches += 1
    return y


@_qconv_op.register_fake
def _qconv_fake(xq: torch.Tensor, wp: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor, bias: Optional[torch.Tensor],
                geometry: Sequence[int], out_dtype: torch.dtype
                ) -> torch.Tensor:
    return xq.new_empty((xq.shape[0], sw.shape[0], geometry[8],
                         geometry[9]), dtype=out_dtype)


quant_act.launches = 0  # kernel launches since the last reset
qconv_int8.launches = 0
