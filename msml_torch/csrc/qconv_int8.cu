// int8 post-training quantization for Hopper (sm_90a): the dynamic
// per-sample activation quantizer and the int8 implicit-GEMM convolution
// with int32 accumulators and a per-sample x per-channel dequantizing
// epilogue. They run the convolutions and the fc that
// msml_tpu/core/quantize.py rewrites to int8 (there XLA lowers them); the
// design notes are in msml_torch/kernels/qconv.py.
//
// Plain C interface for ctypes: every entry point launches on the caller's
// stream, allocates nothing, and returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // 8 warps, every kernel here
constexpr int AMAX_PER_THREAD = 16;
constexpr int QT_PIX = 64;       // pixels of one quantize tile
constexpr int QT_CH = 32;        // channels of one quantize tile (= CP_ALIGN)
constexpr int BM = 64;           // output channels of a conv block
constexpr int BN = 128;          // output pixels (over the batch) of a block
constexpr int BK = 32;           // K of one stage: one mma k32 step
constexpr int PITCH = 48;        // bytes of a staged row of BK: 12 words, so
                                 // a fragment load hits 32 distinct banks
constexpr int STAGES = 4;        // cp.async ring depth
constexpr int CP_ALIGN = 32;     // channel padding of the int8 activations

// f32(1 / 127): XLA compiles the reference's `amax / 127` into a multiply
// by this rounded reciprocal
__device__ __forceinline__ float inv_qmax() { return __uint_as_float(0x3c010204u); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// clip(rint(v / s), -127, 127): IEEE division, round half to even
__device__ __forceinline__ uint32_t quant_byte(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(__float2int_rn(q))));
}

// max |x| over the c * hw elements of each sample, as the bits of a
// non-negative float (their integer order is the float order), by
// atomicMax into amax[n], which the caller zeroed: the same result
// whatever order the blocks run in
template <typename T>
__global__ void __launch_bounds__(THREADS)
act_amax(const T* __restrict__ x, unsigned* __restrict__ amax,
         long long per_sample) {
  const int n = blockIdx.y;
  const long long base = (long long)blockIdx.x * THREADS * AMAX_PER_THREAD;
  const T* xn = x + (size_t)n * per_sample;
  float m = 0.f;
#pragma unroll 4
  for (int j = 0; j < AMAX_PER_THREAD; ++j) {
    const long long i = base + threadIdx.x + (long long)j * THREADS;
    if (i < per_sample) m = fmaxf(m, fabsf(to_f32(xn[i])));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float part[THREADS / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, part[w]);
    atomicMax(amax + n, __float_as_uint(m));
  }
}

__device__ __forceinline__ float act_scale(const unsigned* amax, int n) {
  return fmaxf(__fmul_rn(__uint_as_float(amax[n]), inv_qmax()), 1e-12f);
}

// NCHW (n, c, hw) -> int8 (n, hw, cp), channels >= c zero. Block (tile of
// QT_PIX pixels, tile of QT_CH channels, n): thread t reads pixel t % 64
// of channels 4 g .. 4 g + 3 and 16 + 4 g .. (g = t / 64), coalesced along
// the pixels, packs each four codes into a word of a [64][9]-word tile
// (conflict-free), then threads 0..127 store the tile's 64 rows of 32
// bytes as 16-byte vectors. Block (0, 0, n) writes sx[n].
template <typename T>
__global__ void __launch_bounds__(THREADS)
act_quant(const T* __restrict__ x, int8_t* __restrict__ xq,
          float* __restrict__ sx, const unsigned* __restrict__ amax, int c,
          int hw, int cp) {
  __shared__ uint32_t tile[QT_PIX * 9];
  const int n = blockIdx.z, p0 = blockIdx.x * QT_PIX, c0 = blockIdx.y * QT_CH;
  const float s = act_scale(amax, n);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) sx[n] = s;
  const int t = threadIdx.x, p = t % QT_PIX, g = t / QT_PIX;
  const T* xn = x + (size_t)n * c * hw;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = c0 + 16 * half + 4 * g + i;
      float v = 0.f;
      if (ch < c && p0 + p < hw) v = to_f32(xn[(size_t)ch * hw + p0 + p]);
      word |= quant_byte(v, s) << (8 * i);
    }
    tile[p * 9 + 4 * half + g] = word;
  }
  __syncthreads();
  if (t < 2 * QT_PIX) {
    const int pr = t >> 1, h = t & 1;
    if (p0 + pr < hw) {
      const uint32_t* src = tile + pr * 9 + 4 * h;
      *reinterpret_cast<uint4*>(xq + ((size_t)n * hw + p0 + pr) * cp + c0
                                + 16 * h) =
          make_uint4(src[0], src[1], src[2], src[3]);
    }
  }
}

// hw == 1 (the fc's input, (n, c)): the layout does not change; thread
// writes codes 4 i .. 4 i + 3 of its sample as one word
template <typename T>
__global__ void __launch_bounds__(THREADS)
act_quant_flat(const T* __restrict__ x, int8_t* __restrict__ xq,
               float* __restrict__ sx, const unsigned* __restrict__ amax,
               int c, int cp) {
  const int n = blockIdx.y;
  const float s = act_scale(amax, n);
  if (blockIdx.x == 0 && threadIdx.x == 0) sx[n] = s;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (4 * i >= cp) return;
  const T* xn = x + (size_t)n * c;
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ch = 4 * i + j;
    word |= quant_byte(ch < c ? to_f32(xn[ch]) : 0.f, s) << (8 * j);
  }
  reinterpret_cast<uint32_t*>(xq + (size_t)n * cp)[i] = word;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// y = v * scale (+ bias): a float32 output adds the bias in the same FMA
// (as XLA contracts the reference's dequantize and bias add); a bfloat16
// output is rounded, then the bias added in bfloat16
__device__ __forceinline__ void store(float* y, float v, float scale,
                                      const float* bias) {
  *y = bias ? __fmaf_rn(v, scale, *bias) : __fmul_rn(v, scale);
}
__device__ __forceinline__ void store(__nv_bfloat16* y, float v, float scale,
                                      const float* bias) {
  __nv_bfloat16 r = __float2bfloat16_rn(__fmul_rn(v, scale));
  if (bias) r = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r), *bias));
  *y = r;
}

struct Geometry {
  int n, h, w, cp, co, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw;
};

// Stage kt into ring slot `slot`: K columns [kt BK, kt BK + BK), the
// channels ci.. of tap (ky, kx). A: this thread's 16 bytes of weight row
// t / 2 (t < 128); B: its 16 bytes of pixel t / 2's input at that tap, or
// zeros where the tap falls on padding or a dilation hole.
__device__ __forceinline__ void load_stage(
    uint8_t* a_dst, uint8_t* b_dst, const int8_t* a_src, const int8_t* x_n,
    const int8_t* x, int t, int slot, int kt, int per_tap, int vy0, int vx0,
    bool p_ok, const Geometry& g) {
  if (t < 2 * BM)
    cp_async16(a_dst + slot * BM * PITCH, a_src + (size_t)kt * BK, true);
  const int tap = kt / per_tap, ci = (kt - tap * per_tap) * BK;
  const int ky = tap / g.kw, kx = tap - ky * g.kw;
  const int vy = vy0 + ky, vx = vx0 + kx;
  const int iy = vy / g.dh, ix = vx / g.dw;
  const bool ok = p_ok && vy >= 0 && vx >= 0 && iy * g.dh == vy &&
                  ix * g.dw == vx && iy < g.h && ix < g.w;
  cp_async16(b_dst + slot * BN * PITCH,
             ok ? x_n + ((size_t)iy * g.w + ix) * g.cp + ci : x, ok);
}

// y = dequant(conv(xq, wp)). GEMM rows M = output channels (wp: (co_pad,
// K) row-major, K = (ky, kx, ci) with ci over the cp padded channels),
// columns N = the batch's output pixels, K in steps of BK = 32 channels of
// one tap. Block (pixel tile, channel tile) of BM x BN; warp (wm, wn) of
// 2 x 4 owns 32 x 32: 2 m16 x 4 n8 tiles of mma.m16n8k32 s8 -> s32. Each
// stage stages A (64 rows x 32 bytes) and B (128 pixels x 32 bytes) by
// 16-byte cp.async with zero fill: pixel (n, oy, ox) reads input row
// iy = (oy sh - ph + ky) / dh where that is a whole number in [0, h)
// (dh > 1: the lhs dilation of a transposed conv), the same for x.
template <typename OUT>
__global__ void __launch_bounds__(THREADS, 2)  // up to 128 registers
qconv(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
      const float* __restrict__ sx, const float* __restrict__ swt,
      const float* __restrict__ bias, OUT* __restrict__ y, Geometry g) {
  __shared__ __align__(16) uint8_t sa[STAGES][BM * PITCH];
  __shared__ __align__(16) uint8_t sb[STAGES][BN * PITCH];
  const int K = g.kh * g.kw * g.cp, KT = K / BK;
  const int howo = g.ho * g.wo, P = g.n * howo;
  const int p0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // this thread's A copy (t < 128: row t / 2, half t % 2) and B copy
  // (pixel t / 2, half t % 2)
  const int8_t* a_src = wp + (size_t)(m0 + (t >> 1)) * K + 16 * (t & 1);
  uint8_t* const a_dst = &sa[0][(t >> 1) * PITCH + 16 * (t & 1)];
  uint8_t* const b_dst = &sb[0][(t >> 1) * PITCH + 16 * (t & 1)];
  const int p = p0 + (t >> 1);
  const bool p_ok = p < P;
  const int pn = p_ok ? p / howo : 0, pix = p_ok ? p % howo : 0;
  const int vy0 = (pix / g.wo) * g.sh - g.ph, vx0 = (pix % g.wo) * g.sw - g.pw;
  const int8_t* x_n = x + (size_t)pn * g.h * g.w * g.cp + 16 * (t & 1);
  const int per_tap = g.cp / BK;

  int acc[2][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage(a_dst, b_dst, a_src, x_n, x, t, s, s, per_tap, vy0, vx0,
                 p_ok, g);
    cp_async_commit();
  }
  const int wm = warp & 1, wn = warp >> 1, gr = lane >> 2, tg = lane & 3;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT)
      load_stage(a_dst, b_dst, a_src, x_n, x, t, (kt + STAGES - 1) % STAGES,
                 kt + STAGES - 1, per_tap, vy0, vx0, p_ok, g);
    cp_async_commit();
    const uint8_t* A = sa[kt % STAGES];
    const uint8_t* B = sb[kt % STAGES];
    uint32_t af[2][4], bfr[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint8_t* r = A + (wm * 32 + mi * 16 + gr) * PITCH + 4 * tg;
      af[mi][0] = lds32(r);
      af[mi][1] = lds32(r + 8 * PITCH);
      af[mi][2] = lds32(r + 16);
      af[mi][3] = lds32(r + 8 * PITCH + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint8_t* r = B + (wn * 32 + ni * 8 + gr) * PITCH + 4 * tg;
      bfr[ni][0] = lds32(r);
      bfr[ni][1] = lds32(r + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
  }
  cp_async_wait<0>();

  // epilogue: float(acc) * (sx[n] * sw[co]) and the bias, to OUT, NCHW
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = m0 + wm * 32 + mi * 16 + gr + 8 * half;
      if (co >= g.co) continue;
      const float s_w = swt[co];
      const float* b = bias ? bias + co : nullptr;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = p0 + wn * 32 + ni * 8 + 2 * tg + j;
          if (q >= P) continue;
          const int qn = q / howo, qpix = q % howo;
          const float scale = __fmul_rn(sx[qn], s_w);
          store(y + ((size_t)qn * g.co + co) * howo + qpix,
                __int2float_rn(acc[mi][ni][2 * half + j]), scale, b);
        }
    }
}

}  // namespace

extern "C" {

// (xq, sx) = quant_act(x): x (n, c, hw) float32 (bf16 == 0) or bfloat16,
// xq int8 (n, hw, cp), cp a multiple of 32 >= c, 16-byte aligned; sx (n,)
// float32; amax (n,) unsigned, a workspace this call zeroes.
int quant_act(const void* x, void* xq, void* sx, void* amax, int n, int c,
              int hw, int cp, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 65535 || c < 1 || hw < 1 || cp % CP_ALIGN != 0 ||
      cp < c || cp / QT_CH > 65535 ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto* am = static_cast<unsigned*>(amax);
  auto* q = static_cast<int8_t*>(xq);
  auto* scale = static_cast<float*>(sx);
  cudaError_t err = cudaMemsetAsync(am, 0, sizeof(unsigned) * n, s);
  if (err != cudaSuccess) return (int)err;
  const long long per = (long long)c * hw;
  const dim3 agrid((unsigned)((per + THREADS * AMAX_PER_THREAD - 1)
                              / (THREADS * AMAX_PER_THREAD)), n);
  const dim3 qgrid((hw + QT_PIX - 1) / QT_PIX, cp / QT_CH, n);
  const dim3 fgrid((cp / 4 + THREADS - 1) / THREADS, n);
#define ACT_LAUNCH(T)                                                        \
  act_amax<T><<<agrid, THREADS, 0, s>>>(static_cast<const T*>(x), am, per); \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;           \
  if (hw == 1)                                                              \
    act_quant_flat<T><<<fgrid, THREADS, 0, s>>>(static_cast<const T*>(x), q, \
                                                scale, am, c, cp);          \
  else                                                                      \
    act_quant<T><<<qgrid, THREADS, 0, s>>>(static_cast<const T*>(x), q,     \
                                           scale, am, c, hw, cp)
  if (bf16) {
    ACT_LAUNCH(__nv_bfloat16);
  } else {
    ACT_LAUNCH(float);
  }
#undef ACT_LAUNCH
  return (int)cudaGetLastError();
}

// y = qconv_int8(xq, wp, sx, sw, bias): xq int8 (n, h, w, cp), wp int8
// (co rounded up to 64, kh * kw * cp), both 16-byte aligned; sx (n,), sw
// (co,) and bias (co,) (or null) float32; y (n, co, ho, wo) float32
// (bf16 == 0) or bfloat16. Stride
// (sh, sw), padding (ph, pw) on the top and left of the input dilated by
// (dh, dw); the bottom and right follow from (ho, wo).
int qconv_int8(const void* xq, const void* wp, const void* sx,
               const void* sw, const void* bias, void* y, int n, int h, int w, int cp, int co,
               int ho, int wo, int kh, int kw, int sh, int swd, int ph,
               int pw, int dh, int dw, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long pixels = (long long)n * ho * wo;
  if (n < 1 || h < 1 || w < 1 || co < 1 || ho < 1 || wo < 1 || kh < 1 ||
      kw < 1 || sh < 1 || swd < 1 || dh < 1 || dw < 1 || ph < 0 || pw < 0 ||
      cp % CP_ALIGN != 0 || pixels > 0x7fffffffLL ||
      (co + BM - 1) / BM > 65535 ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g{n, h, w, cp, co, ho, wo, kh, kw, sh, swd, ph, pw, dh, dw};
  const dim3 grid((unsigned)((pixels + BN - 1) / BN), (co + BM - 1) / BM);
  const auto* xp = static_cast<const int8_t*>(xq);
  const auto* wq = static_cast<const int8_t*>(wp);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  const auto* bp = static_cast<const float*>(bias);
  if (bf16)
    qconv<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        xp, wq, sxp, swp, bp, static_cast<__nv_bfloat16*>(y), g);
  else
    qconv<float><<<grid, THREADS, 0, s>>>(xp, wq, sxp, swp, bp,
                                          static_cast<float*>(y), g);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
