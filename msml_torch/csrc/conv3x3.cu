// 3x3 stride-1 zero-padded convolution at C = 64 (NCHW, OIHW weights):
// forward (also dX, with flipped weights) and dW, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of benchmarks/negative/conv_gemm.py:
// `_fwd_kernel` (launched by `conv3x3_lanes`) and `_dw_kernel` (launched by
// `conv3x3_dw_lanes`). The design notes are in msml_torch/kernels/conv3x3.py.
//
// Plain C interface for ctypes: every entry point launches on the caller's
// stream, allocates nothing, and returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;           // input and output channels
constexpr int THREADS = 256;    // 8 warps (f32 forward and dW, dw_reduce)
constexpr int BM = 128;         // output pixels of one image per f32 forward block
constexpr int KC32 = 16;        // input channels staged per chunk, f32
constexpr int BK = 64;          // pixels per staged f32 dW tile
constexpr int PS32 = BK + 1;    // padded pixel stride of a dW tile, f32
constexpr int MAX_SMEM = 232448;  // an H100 block's opt-in shared memory
constexpr int DW_THREADS = 576;   // bf16 dW: 18 warps, (tap, half of Co)
constexpr int DW_PAD = 8;         // elements left of column 0 in a staged x row
constexpr int X_SLOTS = 4;        // x rows in the ring: three in use, one arriving
constexpr int DY_SLOTS = 2;       // dY rows in the ring: one in use, one arriving
constexpr int FWD_THREADS = 256;  // bf16 forward: 8 warps, (half of Co, tiles)
constexpr int WS = C + 8;         // stride (halves) of a resident weight row and
                                  // of a pixel of the bf16 forward's ring: 36
                                  // words, so a fragment load is conflict-free

// Image rows an f32 forward block stages: the rows its BM pixels touch,
// plus one halo row above and below.
__host__ __device__ inline int rows_staged(int W) {
  return (W + BM - 2) / W + 3;
}

size_t fwd_smem_f32(int W) {
  return (size_t)KC32 * rows_staged(W) * (W + 2) * 4
         + (size_t)9 * KC32 * C * 4;
}

__host__ __device__ inline int round8(int v) { return (v + 7) / 8 * 8; }

// Shared memory of fwd_bf16 for column strips of width sw: the resident
// weights [9][C][WS], the ring of X_SLOTS pixel-major rows [Wk + 2][WS]
// and the landing row [C][DW_PAD + Wk + 8], Wk = sw rounded up to 8.
size_t fwd_smem_bf16(int sw) {
  const int wk = round8(sw);
  return (size_t)2 * (9 * C * WS + X_SLOTS * (wk + 2) * WS
                      + C * (wk + 2 * DW_PAD));
}

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Row stride (halves) of a staged bf16 dW row of `need` elements: a
// multiple of 8 (16-byte rows for cp.async) whose half is an odd multiple
// of 4 words, so that a fragment load (8 rows g x 4 words t) hits 32
// distinct banks.
__host__ __device__ inline int dw_stride(int need) {
  return (need + 7) / 16 * 16 + 8;
}

// Shared memory of dw_bf16 for column strips of width sw: the x ring (both
// copies, DW_PAD + Wk + 8 columns) and the dY ring (Wk columns).
size_t dw_smem_bf16(int sw) {
  const int wk = round16(sw);
  return (size_t)C * 2 * (X_SLOTS * 2 * dw_stride(wk + 2 * DW_PAD)
                          + DY_SLOTS * dw_stride(wk));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared without registers (sm_80+); the block waits
// with cp_async_wait_all before its barrier
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// BYTES (4, 8 or 16) global -> shared without registers; zeros in place of
// the source where !ok (the source is then not read)
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(n));
}

// Forward, f32 in and out, plain FFMA (no TF32). Block (tile, n): output
// pixels [tile * BM, tile * BM + BM) of image n (flattened h * W + w), all
// 64 output channels; per chunk of 16 input channels it stages the input
// rows it needs (halo and zero padding included, channel-major) and the
// chunk's weights; thread (lane, warp) computes pixels lane + 32 i (i < 4)
// and output channels warp * 8 + j.
__global__ void __launch_bounds__(THREADS)
fwd_f32(const float* __restrict__ x, const float* __restrict__ w,
        float* __restrict__ y, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = H * W, WP = W + 2;
  const int n = blockIdx.y, p0 = blockIdx.x * BM;
  const int r_lo = p0 / W;
  const int nr = (min(p0 + BM, HW) - 1) / W - r_lo + 3;
  float* xs = reinterpret_cast<float*>(smem);  // [KC32][nr][WP]
  float* ws = xs + (size_t)KC32 * rows_staged(W) * WP;  // [9][KC32][C]
  const float* xn = x + (size_t)n * C * HW;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int p = min(p0 + lane + 32 * i, HW - 1);
    pos[i] = (p / W - r_lo) * WP + p % W;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int plane = nr * WP;
  for (int c0 = 0; c0 < C; c0 += KC32) {
    __syncthreads();
    // one warp per (channel, staged row); lanes along the row
    for (int q = warp; q < KC32 * nr; q += THREADS / 32) {
      const int k = q / nr, r = q - k * nr, gh = r_lo - 1 + r;
      const bool row_ok = gh >= 0 && gh < H;
      const float* src = xn + (size_t)(c0 + k) * HW + (row_ok ? gh * W : 0);
      float* dst = xs + q * WP;
      for (int c = lane; c < WP; c += 32)
        dst[c] = (row_ok && c >= 1 && c <= W) ? src[c - 1] : 0.f;
    }
    for (int e = tid; e < C * KC32 * 9; e += THREADS) {
      int tap = e % 9, k = (e / 9) % KC32, co = e / (9 * KC32);
      ws[(tap * KC32 + k) * C + co] = w[(co * C + c0 + k) * 9 + tap];
    }
    __syncthreads();
    for (int k = 0; k < KC32; ++k) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float* xk = xs + k * plane + (tap / 3) * WP + tap % 3;
        const float4* wk =
            reinterpret_cast<const float4*>(ws + (tap * KC32 + k) * C) +
            warp * 2;
        float4 w0 = wk[0], w1 = wk[1];
        float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float xv = xk[pos[i]];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
        }
      }
    }
  }
  float* yn = y + (size_t)n * C * HW;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int p = p0 + lane + 32 * i;
    if (p < HW)
#pragma unroll
      for (int j = 0; j < 8; ++j) yn[(size_t)(warp * 8 + j) * HW + p] = acc[i][j];
  }
}

// Tile tt of the f32 dW pixel loop: image n, flattened pixels [p0, p0 +
// BK). Stages dY[n, :, p] and x[n, :, p shifted by the tap] (zero outside
// the image and past its last pixel) as channel rows of BK pixels. Each
// thread keeps one pixel, finds its two offsets once, and walks the
// channels.
__device__ __forceinline__ void stage_dw_tile(
    const float* __restrict__ x, const float* __restrict__ dy, float* ds,
    float* xs, int n, int p0, int H, int W, int ky, int kx) {
  const int HW = H * W, pk = threadIdx.x % BK, p = p0 + pk;
  int dy_at = -1, x_at = -1;
  if (p < HW) {
    const int h = p / W, gh = h + ky - 1, gw = p - h * W + kx - 1;
    dy_at = p;
    if (gh >= 0 && gh < H && gw >= 0 && gw < W) x_at = gh * W + gw;
  }
  const float* dyn = dy + (size_t)n * C * HW;
  const float* xn = x + (size_t)n * C * HW;
  for (int c = threadIdx.x / BK; c < C; c += THREADS / BK) {
    ds[c * PS32 + pk] = dy_at >= 0 ? dyn[(size_t)c * HW + dy_at] : 0.f;
    xs[c * PS32 + pk] = x_at >= 0 ? xn[(size_t)c * HW + x_at] : 0.f;
  }
}

// Row `row` of image plane set `src` (64 channel planes of H x W), columns
// [col0, col0 + ncols), into dst[c * stride + col - col0]: zeros outside
// the columns [lo, hi) and for rows outside the image. VEC elements per
// copy (cp.async of 2 VEC bytes; VEC = 1 through registers for odd W);
// the wrapper picks VEC so that every copy is aligned and lies wholly
// inside or outside [lo, hi). NTHREADS threads share the copies.
template <int VEC, int NTHREADS>
__device__ __forceinline__ void stage_row(uint16_t* dst, int stride,
                                          const uint16_t* __restrict__ src,
                                          int H, int W, int row, int col0,
                                          int ncols, int lo, int hi) {
  const size_t HW = (size_t)H * W;
  const bool row_ok = row >= 0 && row < H;
  const int per_c = ncols / VEC;
  for (int e = threadIdx.x; e < C * per_c; e += NTHREADS) {
    const int c = e / per_c, j = (e - c * per_c) * VEC, col = col0 + j;
    const bool ok = row_ok && col >= lo && col < hi;
    const uint16_t* s = ok ? src + c * HW + (size_t)row * W + col : src;
    uint16_t* d = dst + c * stride + j;
    if constexpr (VEC == 1)
      *d = ok ? *s : uint16_t(0);
    else
      cp_async_zfill<2 * VEC>(d, s, ok);
  }
}

// The shifted copy of a staged x row: xsh[c][j] = xs[c][j + 1] for
// j < DW_PAD + wk, so that the taps kx = 0 and 2 (odd offsets in xs) read
// 32-bit pairs at even offsets: 6 + w and 8 + w.
__device__ __forceinline__ void shift_row(const uint16_t* xs, uint16_t* xsh,
                                          int stride, int wk) {
  const int per_c = (DW_PAD + wk) / 8;
  for (int e = threadIdx.x; e < C * per_c; e += DW_THREADS) {
    const int c = e / per_c, j = (e - c * per_c) * 8;
    const uint16_t* s = xs + c * stride + j;
    const uint4 v = *reinterpret_cast<const uint4*>(s);
    const uint32_t next = *reinterpret_cast<const uint32_t*>(s + 8);
    uint4 o;
    o.x = __funnelshift_r(v.x, v.y, 16);
    o.y = __funnelshift_r(v.y, v.z, 16);
    o.z = __funnelshift_r(v.z, v.w, 16);
    o.w = __funnelshift_r(v.w, next, 16);
    *reinterpret_cast<uint4*>(xsh + c * stride + j) = o;
  }
}

// The landed x row (channel-major, land[c][j] = column c0 - DW_PAD + j) as
// pixel-major ring slot rows: slot[p][c] = column c0 - 1 + p, for
// p < wk + 2, two channels to a 32-bit word. A thread takes one channel
// pair and 8 columns: two 16-byte loads, eight 32-bit stores (a warp's
// stores fill 32 consecutive words of one pixel row).
template <int NTHREADS>
__device__ __forceinline__ void transpose_row(const uint16_t* land, int ls,
                                              uint16_t* slot, int wk) {
  const int pieces = (wk + 2 * DW_PAD) / 8;
  for (int e = threadIdx.x; e < (C / 2) * pieces; e += NTHREADS) {
    const int cp = e % (C / 2), jb = e / (C / 2);
    const uint16_t* s = land + 2 * cp * ls + 8 * jb;
    const uint4 lo = *reinterpret_cast<const uint4*>(s);
    const uint4 hi = *reinterpret_cast<const uint4*>(s + ls);
    const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w};
    const uint32_t u[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = 8 * jb + i - (DW_PAD - 1);
      if (p >= 0 && p < wk + 2)
        reinterpret_cast<uint32_t*>(slot + p * WS)[cp] =
            __byte_perm(l[i / 2], u[i / 2], i % 2 ? 0x7632 : 0x5410);
    }
  }
}

// Forward, bf16 in and out, f32 accumulation on the tensor cores; dX is
// this kernel on flipped weights. Replaces `_fwd_kernel` of
// benchmarks/negative/conv_gemm.py:109:
//   y[n, co, h, w] = sum over ky, kx, ci of w[co, ci, ky, kx]
//                    * x[n, ci, h + ky - 1, w + kx - 1] (zero outside),
// per output row a GEMM with M = Co = 64, N = the row's pixels and
// K = 9 Ci = 576.
//
// Bound at the 112 x 112 site, B = 128: x and y, 411 MB, cross the memory
// once (0.123 ms at 3.35 TB/s); 118.4 GFLOP (0.120 ms at 989 TFLOP/s).
// The design it replaced (v3, 1.0237 ms there on an H100 80GB HBM3 at
// 700 W) ran one block per 128 flattened pixels, 12,544 blocks at 112^2:
// every block reloaded the 73.7 KB of weights (~925 MB through L2), staged
// its ~4 input rows with the halo by 2-byte loads through registers (x
// crossed L2 about 3.5 times), and had no pipeline: per chunk of 32
// channels, barrier, stage, wait, barrier, nine taps.
//
// This kernel: a persistent block walks units (image, strip of <= 128
// columns, run of output rows), units_per_block of them in order
// (dw_rows_geometry: one image per block at B = 128). The packed weights
// (ky, kx, Co, Ci) arrive once per block and stay resident, [9][C][WS]. An
// x row arrives by cp.async (stage_row: zero fill outside the image) into
// one channel-major landing row and is transposed once (transpose_row)
// into a pixel-major ring slot, slot (r - h0 + 1) & 3: rows h - 1, h, h + 1
// in use, row h + 2 made while row h + 3 is in flight. Every x row crosses
// the memory once, plus two halo rows per run. Output row h is the sum of
// nine aligned products, mma.m16n8k16 with A = the tap's weights (pairs
// along Ci) and B = slot row h + ky - 1 at pixel w + kx (pairs along Ci):
// a pixel is a whole WS row of the slot, so the odd tap offsets need no
// shifted copy. N is the row padded to 8; the 8 warps own (half of Co,
// every fourth n8 tile of the row); 16 warps, each with half the tiles,
// need 3 shared loads per mma instead of 2 and were slower at every site. The accumulators hold two neighbouring pixels
// of one output channel, rounded to bf16 once and stored along W (one
// 32-bit store per pair when W is even). Each output is summed by one
// thread in a fixed order: runs are bit-equal.
template <int VEC>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fwd_bf16(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
         __nv_bfloat16* __restrict__ y, int H, int W, int sw,
         int rows_per_run, int units_per_block, int units) {
  constexpr int NTHREADS = FWD_THREADS;
  constexpr int NG = NTHREADS / 64;  // warps per half of Co
  constexpr int NI = 16 / NG;        // n8 tiles a warp owns at most (Wk <= 128)
  extern __shared__ __align__(16) unsigned char smem[];
  const int strips = (W + sw - 1) / sw;
  const int runs = (H + rows_per_run - 1) / rows_per_run;
  const int LS = round8(sw) + 2 * DW_PAD;  // landing row stride
  const int SP = (round8(sw) + 2) * WS;    // ring slot size
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem);  // [9][C][WS]
  uint16_t* ring = ws + 9 * C * WS;                  // [slot][Wk + 2][WS]
  uint16_t* land = ring + X_SLOTS * SP;              // [C][LS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 32, ng = warp >> 1;

  // (tap, co) rows of 64 input channels, eight 16-byte pieces each; the
  // first row's wait and barrier cover them
  for (int e = tid; e < 9 * C * (C / 8); e += NTHREADS)
    cp_async16(ws + (e / 8) * WS + (e % 8) * 8, w + e * 8);

  float acc[2][NI][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0.f;

  const bool pairs = W % 2 == 0;
  const int u0 = blockIdx.x * units_per_block;
  const int u_end = min(units, u0 + units_per_block);
  for (int u = u0; u < u_end; ++u) {
    const int run = u % runs, strip = (u / runs) % strips;
    const int n = u / (runs * strips);
    const int c0 = strip * sw, cw = min(sw, W - c0), wk = round8(cw);
    const int nt_row = wk / 8;
    const int h0 = run * rows_per_run, h1 = min(H, h0 + rows_per_run);
    const uint16_t* xn = x + (size_t)n * C * H * W;
    auto slot = [&](int r) {
      return ring + ((r - h0 + 1) & (X_SLOTS - 1)) * SP;
    };
    // x row r has been asked for: once it lands and every warp is done
    // with the slot it takes (that of row r - 4), transpose it there, then
    // ask for row r + 1 if the run needs it (rows h0 - 1 .. h1)
    auto advance = [&](int r) {
      cp_async_wait_all();
      __syncthreads();
      transpose_row<NTHREADS>(land, LS, slot(r), wk);
      __syncthreads();
      if (r + 1 <= h1)
        stage_row<VEC, NTHREADS>(land, LS, xn, H, W, r + 1, c0 - DW_PAD,
                                 wk + 2 * DW_PAD, 0, W);
    };
    stage_row<VEC, NTHREADS>(land, LS, xn, H, W, h0 - 1, c0 - DW_PAD,
                             wk + 2 * DW_PAD, 0, W);
    advance(h0 - 1);
    advance(h0);
    advance(h0 + 1);
    for (int h = h0; h < h1; ++h) {
      if (h + 2 <= h1) advance(h + 2);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        const uint16_t* as = ws + (tap * C + m0 + g) * WS + 2 * t;
        const uint16_t* bs = slot(h + ky - 1) + (g + kx) * WS + 2 * t;
#pragma unroll
        for (int k0 = 0; k0 < C; k0 += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const uint16_t* r0 = as + mi * 16 * WS + k0;
            a[mi][0] = ld32(r0);
            a[mi][1] = ld32(r0 + 8 * WS);
            a[mi][2] = ld32(r0 + 8);
            a[mi][3] = ld32(r0 + 8 * WS + 8);
          }
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            const int nt = ng + j * NG;
            if (nt < nt_row) {
              const uint16_t* q = bs + nt * 8 * WS + k0;
              const uint32_t b[2] = {ld32(q), ld32(q + 8)};
              mma_bf16(acc[0][j], a[0], b);
              mma_bf16(acc[1][j], a[1], b);
            }
          }
        }
      }
      // y[n, co, h, c0 + wc], y[n, co, h, c0 + wc + 1] for wc < cw
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int wc = (ng + j * NG) * 8 + 2 * t;
          if (wc < cw) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int co = m0 + mi * 16 + g + 8 * half;
              const float v0 = acc[mi][j][2 * half];
              const float v1 = acc[mi][j][2 * half + 1];
              __nv_bfloat16* out =
                  y + ((size_t)(n * C + co) * H + h) * W + c0 + wc;
              if (pairs) {
                *reinterpret_cast<__nv_bfloat162*>(out) =
                    __floats2bfloat162_rn(v0, v1);
              } else {
                out[0] = __float2bfloat16_rn(v0);
                if (wc + 1 < cw) out[1] = __float2bfloat16_rn(v1);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0.f;
        }
    }
  }
}

// dW, bf16 inputs, on the tensor cores. Replaces `_dw_kernel` of
// benchmarks/negative/conv_gemm.py:186:
//   dW[co, ci, ky, kx] = sum over n, h, w of dY[n, co, h, w]
//                        * x[n, ci, h + ky - 1, w + kx - 1],
// a GEMM with M = Co = 64, N = 9 Ci = 576, K = the pixels.
//
// Bound at the 112 x 112 site, B = 128: x and dY, 411 MB, cross the memory
// once (0.123 ms at 3.35 TB/s); 118.4 GFLOP (0.120 ms at 989 TFLOP/s).
// The design it replaced (v2, 1.9311 ms there on an H100 80GB HBM3 at
// 700 W) ran one block per (tap, chunk of 64-pixel tiles), each staging dY
// and its own tap-shifted x with scalar loads between two barriers: every
// byte of x and dY was staged 9 times, and staging set the time.
//
// This kernel: a block walks units (image, strip of <= 128 columns, run of
// output rows), units_per_block of them in order; for output row h it
// needs dY row h and x rows h - 1, h, h + 1. The x rows sit in a ring of
// X_SLOTS in shared memory (three in use, one arriving), the dY rows in a
// ring of two, and the next rows arrive by cp.async while the tensor cores
// work on the current one: each x and dY row is staged once for all nine
// taps, plus two halo rows per run. Warps own the taps: warp = (tap, half
// of Co), each with a 32 x 64 f32 accumulator (64 registers a thread), and
// every tap reads the same staged rows.
// mma.m16n8k16 pairs two neighbouring pixels in a 32-bit word, so an
// operand must start at an even element. x rows are staged at a left pad of
// DW_PAD = 8 (global column c0 + w at element 8 + w), tap kx = 1 reads
// element 8 + w; the odd shifts kx = 0, 2 read a second copy shifted by one
// element (shift_row) at 6 + w and 8 + w. K is padded to Wk, the strip
// width rounded up to 16: dY columns past the strip and x columns outside
// the image are zero (cp.async zero fill), and so are x rows outside it.
// Each block sums its rows in order into its own (9, Co, Ci) partial;
// dw_reduce adds the partials in block order: no atomics, the same bits on
// every run.
template <int VEC>
__global__ void __launch_bounds__(DW_THREADS, 1)
dw_bf16(const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
        float* __restrict__ partial, int H, int W, int sw, int rows_per_run,
        int units_per_block, int units) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int strips = (W + sw - 1) / sw;
  const int runs = (H + rows_per_run - 1) / rows_per_run;
  const int XS = dw_stride(round16(sw) + 2 * DW_PAD);
  const int DS = dw_stride(round16(sw));
  uint16_t* xring = reinterpret_cast<uint16_t*>(smem);  // [slot][2][C][XS]
  uint16_t* dring = xring + X_SLOTS * 2 * C * XS;        // [slot][C][DS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tap = warp >> 1, ky = tap / 3, kx = tap % 3;
  const int m0 = (warp & 1) * 32;
  // this warp's B operand in a slot: the aligned copy at DW_PAD for kx = 1,
  // the shifted copy at 6 (kx = 0) or 8 (kx = 2)
  const int b_off = (kx == 1 ? 0 : C * XS) + g * XS + (kx == 0 ? 6 : 8)
                    + 2 * t;
  const int a_off = (m0 + g) * DS + 2 * t;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  const int u0 = blockIdx.x * units_per_block;
  const int u_end = min(units, u0 + units_per_block);
  for (int u = u0; u < u_end; ++u) {
    const int run = u % runs, strip = (u / runs) % strips;
    const int n = u / (runs * strips);
    const int c0 = strip * sw, cw = min(sw, W - c0), wk = round16(cw);
    const int h0 = run * rows_per_run, h1 = min(H, h0 + rows_per_run);
    const uint16_t* xn = x + (size_t)n * C * H * W;
    const uint16_t* dyn = dy + (size_t)n * C * H * W;
    auto xslot = [&](int r) {
      return xring + ((r - h0 + 1) & (X_SLOTS - 1)) * 2 * C * XS;
    };
    auto dslot = [&](int r) {
      return dring + ((r - h0) & (DY_SLOTS - 1)) * C * DS;
    };
    auto stage_x = [&](int r) {
      stage_row<VEC, DW_THREADS>(xslot(r), XS, xn, H, W, r, c0 - DW_PAD,
                     wk + 2 * DW_PAD, 0, W);
    };
    auto stage_dy = [&](int r) {
      stage_row<VEC, DW_THREADS>(dslot(r), DS, dyn, H, W, r, c0, wk, c0, c0 + cw);
    };

    __syncthreads();  // every warp is done with the previous unit's rows
    stage_x(h0 - 1);
    stage_x(h0);
    cp_async_wait_all();
    __syncthreads();
    shift_row(xslot(h0 - 1), xslot(h0 - 1) + C * XS, XS, wk);
    shift_row(xslot(h0), xslot(h0) + C * XS, XS, wk);
    stage_x(h0 + 1);
    stage_dy(h0);
    for (int h = h0; h < h1; ++h) {
      // x row h + 1 and dY row h have landed; every warp is done with row
      // h - 1, so the slots of x row h - 2 and dY row h - 1 are free
      cp_async_wait_all();
      __syncthreads();
      shift_row(xslot(h + 1), xslot(h + 1) + C * XS, XS, wk);
      if (h + 1 < h1) {
        stage_x(h + 2);
        stage_dy(h + 1);
      }
      __syncthreads();
      const uint16_t* as = dslot(h) + a_off;
      const uint16_t* bs = xslot(h + ky - 1) + b_off;
      for (int ks = 0; ks < wk; ks += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint16_t* r0 = as + mi * 16 * DS + ks;
          a[mi][0] = ld32(r0);
          a[mi][1] = ld32(r0 + 8 * DS);
          a[mi][2] = ld32(r0 + 8);
          a[mi][3] = ld32(r0 + 8 * DS + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const uint16_t* q = bs + ni * 8 * XS + ks;
          const uint32_t b[2] = {ld32(q), ld32(q + 8)};
          mma_bf16(acc[0][ni], a[0], b);
          mma_bf16(acc[1][ni], a[1], b);
        }
      }
    }
  }

  float* out = partial + ((size_t)blockIdx.x * 9 + tap) * C * C;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int co = m0 + mi * 16 + g, ci = ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + co * C + ci) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (co + 8) * C + ci) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// dW, f32 inputs, plain FFMA. Block (tap, chunk) sums dY[co, p] x[ci, p +
// tap shift] over the pixels of its chunk of 64-pixel tiles into an f32
// (Co, Ci) partial; thread (tx, ty) of a 16 x 16 grid sums co = ty + 16 j
// and ci = tx + 16 i.
__global__ void __launch_bounds__(THREADS)
dw_f32(const float* __restrict__ x, const float* __restrict__ dy,
       float* __restrict__ partial, int H, int W, int tiles_per_image,
       int tiles_per_chunk, int total_tiles) {
  __shared__ float ds[C * PS32];
  __shared__ float xs[C * PS32];
  const int tap = blockIdx.x, chunk = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int t_end = min(total_tiles, (chunk + 1) * tiles_per_chunk);
  for (int tt = chunk * tiles_per_chunk; tt < t_end; ++tt) {
    __syncthreads();
    stage_dw_tile(x, dy, ds, xs, tt / tiles_per_image,
                  (tt % tiles_per_image) * BK, H, W, tap / 3, tap % 3);
    __syncthreads();
    for (int pk = 0; pk < BK; ++pk) {
      float dv[4], xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = ds[(ty + 16 * j) * PS32 + pk];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[(tx + 16 * i) * PS32 + pk];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(dv[j], xv[i], acc[j][i]);
    }
  }
  float* out = partial + ((size_t)chunk * 9 + tap) * C * C;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) out[(ty + 16 * j) * C + tx + 16 * i] = acc[j][i];
}

// dW[co, ci, tap] = the sum of the chunks' partials, in chunk order: the
// same result on every run.
__global__ void __launch_bounds__(THREADS)
dw_reduce(const float* __restrict__ partial, float* __restrict__ dw,
          int chunks) {
  const int e = blockIdx.x * THREADS + threadIdx.x;  // (tap, co, ci)
  if (e >= 9 * C * C) return;
  float s = 0.f;
  for (int ch = 0; ch < chunks; ++ch) s += partial[(size_t)ch * 9 * C * C + e];
  const int tap = e / (C * C), co = (e / C) % C, ci = e % C;
  dw[(co * C + ci) * 9 + tap] = s;
}

template <typename K>
cudaError_t allow_smem(K kernel, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  *done = err == cudaSuccess;
  return err;
}

}  // namespace

extern "C" {

// y = conv3x3(x, w): x (n, 64, h, wd), y like x; w is (64, 64, 3, 3)
// (Co, Ci, ky, kx) for float32 and packed (3, 3, 64, 64) (ky, kx, Co, Ci)
// for bfloat16 (bf16 != 0). The bf16 kernel's blocking: column strips of
// sw, runs of rows_per_run rows, units_per_block (image, strip, run) units
// per block, `blocks` blocks, copies of vec elements (8, 4, 2 or 1); the
// f32 kernel ignores them.
int conv3x3_fwd(const void* x, const void* w, void* y, int n, int h, int wd,
                int bf16, int sw, int rows_per_run, int units_per_block,
                int blocks, int vec, void* stream) {
  static bool ready_f32 = false, ready[4] = {};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!bf16) {
    const size_t smem = fwd_smem_f32(wd);
    if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
    if ((err = allow_smem(fwd_f32, &ready_f32)) != cudaSuccess)
      return (int)err;
    fwd_f32<<<dim3((h * wd + BM - 1) / BM, n), THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), h, wd);
    return (int)cudaGetLastError();
  }
  const size_t smem = fwd_smem_bf16(sw);
  if (smem > (size_t)MAX_SMEM || sw % 8 != 0 || sw > 128 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int units = n * ((wd + sw - 1) / sw)
                    * ((h + rows_per_run - 1) / rows_per_run);
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* wp = static_cast<const uint16_t*>(w);
  auto* yp = static_cast<__nv_bfloat16*>(y);
#define FWD_LAUNCH(V, I)                                                     \
  if ((err = allow_smem(fwd_bf16<V>, &ready[I])) != cudaSuccess)             \
    return (int)err;                                                         \
  fwd_bf16<V><<<blocks, FWD_THREADS, smem, s>>>(                             \
      xp, wp, yp, h, wd, sw, rows_per_run, units_per_block, units)
  switch (vec) {
    case 8: FWD_LAUNCH(8, 0); break;
    case 4: FWD_LAUNCH(4, 1); break;
    case 2: FWD_LAUNCH(2, 2); break;
    case 1: FWD_LAUNCH(1, 3); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD_LAUNCH
  return (int)cudaGetLastError();
}

// dw (64, 64, 3, 3) f32 = the weight gradient of conv3x3 for input x and
// output gradient dy, both (n, 64, h, wd) float32; partial is (chunks, 9,
// 64, 64) f32 scratch. Pixel tiles of 64, tiles_per_chunk of them per
// block.
int conv3x3_dw_f32(const void* x, const void* dy, void* partial, void* dw,
                   int n, int h, int wd, int tiles_per_chunk, int chunks,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_per_image = (h * wd + BK - 1) / BK;
  dw_f32<<<dim3(9, chunks), THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<float*>(partial), h, wd, tiles_per_image, tiles_per_chunk,
      n * tiles_per_image);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dw_reduce<<<(9 * C * C + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), chunks);
  return (int)cudaGetLastError();
}

// The same for bfloat16 x and dy: column strips of sw, runs of
// rows_per_run rows, units_per_block (image, strip, run) units per block,
// `blocks` blocks and partials; copies of vec elements (8, 4, 2 or 1).
int conv3x3_dw_bf16(const void* x, const void* dy, void* partial, void* dw,
                    int n, int h, int wd, int sw, int rows_per_run,
                    int units_per_block, int blocks, int vec, void* stream) {
  static bool ready[4] = {false, false, false, false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = dw_smem_bf16(sw);
  if (smem > (size_t)MAX_SMEM || sw % 8 != 0 || sw > 128)
    return (int)cudaErrorInvalidValue;
  const int units = n * ((wd + sw - 1) / sw)
                    * ((h + rows_per_run - 1) / rows_per_run);
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* dp = static_cast<const uint16_t*>(dy);
  auto* pp = static_cast<float*>(partial);
  cudaError_t err;
#define DW_LAUNCH(V, I)                                                     \
  if ((err = allow_smem(dw_bf16<V>, &ready[I])) != cudaSuccess)              \
    return (int)err;                                                         \
  dw_bf16<V><<<blocks, DW_THREADS, smem, s>>>(xp, dp, pp, h, wd, sw,         \
                                              rows_per_run, units_per_block, \
                                              units)
  switch (vec) {
    case 8: DW_LAUNCH(8, 0); break;
    case 4: DW_LAUNCH(4, 1); break;
    case 2: DW_LAUNCH(2, 2); break;
    case 1: DW_LAUNCH(1, 3); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DW_LAUNCH
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dw_reduce<<<(9 * C * C + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), blocks);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
