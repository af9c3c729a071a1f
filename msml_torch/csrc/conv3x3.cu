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
constexpr int BK = 64;          // pixels per staged dW tile
constexpr int PS16 = BK + 8;    // padded pixel stride of a dW tile, bf16
constexpr int PS32 = BK + 1;    // padded pixel stride of a dW tile, f32
constexpr int MAX_SMEM = 232448;  // an H100 block's opt-in shared memory

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

// Tile tt of the dW pixel loop: image n, flattened pixels [p0, p0 + BK).
// Stages dY[n, :, p] and x[n, :, p shifted by the tap] (zero outside the
// image and past its last pixel) as channel rows of BK pixels. Each thread
// keeps one pixel, finds its two offsets once, and walks the channels.
template <typename T, int PSTRIDE>
__device__ __forceinline__ void stage_dw_tile(
    const T* __restrict__ x, const T* __restrict__ dy, T* ds, T* xs, int n,
    int p0, int H, int W, int ky, int kx) {
  const int HW = H * W, pk = threadIdx.x % BK, p = p0 + pk;
  int dy_at = -1, x_at = -1;
  if (p < HW) {
    const int h = p / W, gh = h + ky - 1, gw = p - h * W + kx - 1;
    dy_at = p;
    if (gh >= 0 && gh < H && gw >= 0 && gw < W) x_at = gh * W + gw;
  }
  const T* dyn = dy + (size_t)n * C * HW;
  const T* xn = x + (size_t)n * C * HW;
  for (int c = threadIdx.x / BK; c < C; c += THREADS / BK) {
    ds[c * PSTRIDE + pk] = dy_at >= 0 ? dyn[(size_t)c * HW + dy_at] : T(0);
    xs[c * PSTRIDE + pk] = x_at >= 0 ? xn[(size_t)c * HW + x_at] : T(0);
  }
}

// dW, bf16 inputs, on the tensor cores. Block (tap, chunk) sums
// dY[co, p] x[ci, p + tap shift] over the pixels of its chunk of tiles
// into an f32 (Co, Ci) partial: GEMM M = Co, N = Ci, K = pixels; warps
// 2 x 4, each a 32 x 16 tile. No atomics: dw_reduce sums the partials.
__global__ void __launch_bounds__(THREADS)
dw_bf16(const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
        float* __restrict__ partial, int H, int W, int tiles_per_image,
        int tiles_per_chunk, int total_tiles) {
  __shared__ __align__(16) uint16_t ds[C * PS16];
  __shared__ __align__(16) uint16_t xs[C * PS16];
  const int tap = blockIdx.x, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  float acc[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  const int t_end = min(total_tiles, (chunk + 1) * tiles_per_chunk);
  for (int tt = chunk * tiles_per_chunk; tt < t_end; ++tt) {
    __syncthreads();
    stage_dw_tile<uint16_t, PS16>(x, dy, ds, xs, tt / tiles_per_image,
                                  (tt % tiles_per_image) * BK, H, W, tap / 3,
                                  tap % 3);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[2][4], b[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint16_t* r0 = ds + (wm * 32 + mi * 16 + g) * PS16 + ks + 2 * t;
        const uint16_t* r1 = r0 + 8 * PS16;
        a[mi][0] = ld32(r0);
        a[mi][1] = ld32(r1);
        a[mi][2] = ld32(r0 + 8);
        a[mi][3] = ld32(r1 + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const uint16_t* q = xs + (wn * 16 + ni * 8 + g) * PS16 + ks + 2 * t;
        b[ni][0] = ld32(q);
        b[ni][1] = ld32(q + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }
  float* out = partial + ((size_t)chunk * 9 + tap) * C * C;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      int co = wm * 32 + mi * 16 + g, ci = wn * 16 + ni * 8 + 2 * t;
      out[co * C + ci] = acc[mi][ni][0];
      out[co * C + ci + 1] = acc[mi][ni][1];
      out[(co + 8) * C + ci] = acc[mi][ni][2];
      out[(co + 8) * C + ci + 1] = acc[mi][ni][3];
    }
}

// dW, f32 inputs, plain FFMA. Same blocks as dw_bf16; thread (tx, ty) of a
// 16 x 16 grid sums co = ty + 16 j and ci = tx + 16 i.
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
    stage_dw_tile<float, PS32>(x, dy, ds, xs, tt / tiles_per_image,
                               (tt % tiles_per_image) * BK, H, W, tap / 3,
                               tap % 3);
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
// output gradient dy, both (n, 64, h, wd); partial is (chunks, 9, 64, 64)
// f32 scratch. Pixel tiles of 64, tiles_per_chunk of them per block.
int conv3x3_dw(const void* x, const void* dy, void* partial, void* dw, int n,
               int h, int wd, int tiles_per_chunk, int chunks, int bf16,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_per_image = (h * wd + BK - 1) / BK;
  const int total = n * tiles_per_image;
  dim3 grid(9, chunks);
  if (bf16)
    dw_bf16<<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
        static_cast<float*>(partial), h, wd, tiles_per_image,
        tiles_per_chunk, total);
  else
    dw_f32<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(partial), h, wd, tiles_per_image,
        tiles_per_chunk, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dw_reduce<<<(9 * C * C + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), chunks);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
