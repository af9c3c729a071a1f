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
constexpr int THREADS = 256;    // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int BM = 128;         // output pixels of one image per forward block
constexpr int KC16 = 32;        // input channels staged per chunk, bf16
constexpr int KS16 = KC16 + 8;  // their padded stride in smem (halves)
constexpr int KC32 = 16;        // input channels staged per chunk, f32
constexpr int YS = BM + 4;      // padded pixel stride of the bf16 epilogue
constexpr int BK = 64;          // pixels per staged f32 dW tile
constexpr int PS32 = BK + 1;    // padded pixel stride of a dW tile, f32
constexpr int MAX_SMEM = 232448;  // an H100 block's opt-in shared memory
constexpr int DW_THREADS = 576;   // bf16 dW: 18 warps, (tap, half of Co)
constexpr int DW_PAD = 8;         // elements left of column 0 in a staged x row
constexpr int X_SLOTS = 4;        // x rows in the ring: three in use, one arriving
constexpr int DY_SLOTS = 2;       // dY rows in the ring: one in use, one arriving

// Image rows a forward block stages: the rows its BM pixels touch, plus
// one halo row above and below.
__host__ __device__ inline int rows_staged(int W) {
  return (W + BM - 2) / W + 3;
}

size_t fwd_smem_bf16(int W) {
  size_t staged = (size_t)rows_staged(W) * (W + 2) * KS16 * 2
                  + (size_t)9 * C * KS16 * 2;
  size_t epilogue = (size_t)C * YS * 4;
  return staged > epilogue ? staged : epilogue;
}

size_t fwd_smem_f32(int W) {
  return (size_t)KC32 * rows_staged(W) * (W + 2) * 4
         + (size_t)9 * KC32 * C * 4;
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

// Forward, bf16 in and out, f32 accumulation on the tensor cores.
// Block (tile, n): output pixels [tile * BM, tile * BM + BM) of image n
// (flattened h * W + w), all 64 output channels. Implicit GEMM with
// M = pixels, N = Co, K = (tap, ci): per chunk of 32 input channels the
// block stages the input rows it needs (halo and zero padding included,
// channels innermost, two channels to a 32-bit word) and the chunk's
// weights (w packed (3, 3, Co, Ci), 16-byte loads), then each warp runs
// mma.m16n8k16 over a 32 x 32 (pixel x Co) tile for the 9 taps.
__global__ void __launch_bounds__(THREADS)
fwd_bf16(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
         __nv_bfloat16* __restrict__ y, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = H * W, WP = W + 2;
  const int n = blockIdx.y, p0 = blockIdx.x * BM;
  const int r_lo = p0 / W;
  const int nr = (min(p0 + BM, HW) - 1) / W - r_lo + 3;
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem);  // [nr][WP][KS16]
  uint16_t* ws = xs + (size_t)rows_staged(W) * WP * KS16;  // [9][C][KS16]
  const uint16_t* xn = x + (size_t)n * C * HW;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps

  // staged position of tap (0, 0) for this thread's A rows: m-tile mi,
  // rows g (i = 2 mi) and g + 8 (i = 2 mi + 1); pixels past the image
  // read a valid position and are not stored
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int p = min(p0 + wm * 32 + (i >> 1) * 16 + (i & 1) * 8 + g, HW - 1);
    pos[i] = (p / W - r_lo) * WP + p % W;
  }
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC16) {
    __syncthreads();
    // (tap, co) rows of 32 input channels, four 16-byte pieces each,
    // copied asynchronously while the input rows are staged
#pragma unroll
    for (int e = tid; e < 9 * C * (KC16 / 8); e += THREADS) {
      const int row = e / (KC16 / 8), piece = e % (KC16 / 8);
      cp_async16(ws + row * KS16 + piece * 8, w + row * C + c0 + piece * 8);
    }
    // one warp per (channel pair, staged row), lanes along the row; two
    // rows and four column slots per pass, so that 16 loads are in flight
    const int nq = (KC16 / 2) * nr;
    for (int q0 = warp; q0 < nq; q0 += 2 * NWARPS) {
      uint32_t v[2][4];
      uint32_t* dst[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = q0 + j * NWARPS, kp = q / nr, r = q - kp * nr;
        const int gh = r_lo - 1 + r;
        const bool row_ok = q < nq && gh >= 0 && gh < H;
        const uint16_t* src = xn + (size_t)(c0 + 2 * kp) * HW
                              + (row_ok ? gh * W : 0);
        dst[j] = q < nq ? reinterpret_cast<uint32_t*>(xs + r * WP * KS16)
                              + kp : nullptr;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = lane + 32 * i;
          v[j][i] = row_ok && c >= 1 && c <= W
                        ? src[c - 1] | (uint32_t(src[HW + c - 1]) << 16)
                        : 0u;
        }
        for (int c = lane + 128; c < WP; c += 32)  // rows wider than 126
          if (dst[j])
            dst[j][c * (KS16 / 2)] = row_ok && c <= W
                ? src[c - 1] | (uint32_t(src[HW + c - 1]) << 16) : 0u;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (dst[j] && lane + 32 * i < WP)
            dst[j][(lane + 32 * i) * (KS16 / 2)] = v[j][i];
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * WP + tap % 3;
#pragma unroll
      for (int ks = 0; ks < KC16; ks += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const uint16_t* r0 = xs + (pos[2 * mi] + toff) * KS16 + ks + 2 * t;
          const uint16_t* r1 =
              xs + (pos[2 * mi + 1] + toff) * KS16 + ks + 2 * t;
          a[mi][0] = ld32(r0);
          a[mi][1] = ld32(r1);
          a[mi][2] = ld32(r0 + 8);
          a[mi][3] = ld32(r1 + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const uint16_t* q =
              ws + (tap * C + wn * 32 + ni * 8 + g) * KS16 + ks + 2 * t;
          b[ni][0] = ld32(q);
          b[ni][1] = ld32(q + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
      }
    }
  }

  // epilogue through smem, so that the stores run along the pixels
  __syncthreads();
  float* ys = reinterpret_cast<float*>(smem);  // [C][YS]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      int co = wn * 32 + ni * 8 + 2 * t, pm = wm * 32 + mi * 16 + g;
      ys[co * YS + pm] = acc[mi][ni][0];
      ys[(co + 1) * YS + pm] = acc[mi][ni][1];
      ys[co * YS + pm + 8] = acc[mi][ni][2];
      ys[(co + 1) * YS + pm + 8] = acc[mi][ni][3];
    }
  __syncthreads();
  __nv_bfloat16* yn = y + (size_t)n * C * HW;
  for (int e = tid; e < C * BM; e += THREADS) {
    int pm = e % BM, co = e / BM;
    if (p0 + pm < HW)
      yn[(size_t)co * HW + p0 + pm] = __float2bfloat16_rn(ys[co * YS + pm]);
  }
}

// Forward, f32 in and out, plain FFMA (no TF32). Same tiling as fwd_bf16;
// chunks of 16 input channels, staged channel-major; thread (lane, warp)
// computes pixels lane + 32 i (i < 4) and output channels warp * 8 + j.
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
// inside or outside [lo, hi).
template <int VEC>
__device__ __forceinline__ void stage_row(uint16_t* dst, int stride,
                                          const uint16_t* __restrict__ src,
                                          int H, int W, int row, int col0,
                                          int ncols, int lo, int hi) {
  const size_t HW = (size_t)H * W;
  const bool row_ok = row >= 0 && row < H;
  const int per_c = ncols / VEC;
  for (int e = threadIdx.x; e < C * per_c; e += DW_THREADS) {
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
      stage_row<VEC>(xslot(r), XS, xn, H, W, r, c0 - DW_PAD,
                     wk + 2 * DW_PAD, 0, W);
    };
    auto stage_dy = [&](int r) {
      stage_row<VEC>(dslot(r), DS, dyn, H, W, r, c0, wk, c0, c0 + cw);
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
// for bfloat16 (bf16 != 0).
int conv3x3_fwd(const void* x, const void* w, void* y, int n, int h, int wd,
                int bf16, void* stream) {
  static bool ready_bf16 = false, ready_f32 = false;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((h * wd + BM - 1) / BM, n);
  size_t smem = bf16 ? fwd_smem_bf16(wd) : fwd_smem_f32(wd);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16) {
    if ((err = allow_smem(fwd_bf16, &ready_bf16)) != cudaSuccess)
      return (int)err;
    fwd_bf16<<<grid, THREADS, smem, s>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
        static_cast<__nv_bfloat16*>(y), h, wd);
  } else {
    if ((err = allow_smem(fwd_f32, &ready_f32)) != cudaSuccess)
      return (int)err;
    fwd_f32<<<grid, THREADS, smem, s>>>(static_cast<const float*>(x),
                                        static_cast<const float*>(w),
                                        static_cast<float*>(y), h, wd);
  }
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
