// int8 post-training quantization for Hopper (sm_90a): the dynamic
// per-sample activation quantizer and the int8 implicit-GEMM convolution
// with int32 accumulators and a per-sample x per-channel dequantizing
// epilogue. They run the convolutions and the fc that
// msml_tpu/core/quantize.py rewrites to int8 (there XLA lowers them); the
// design notes are in msml_torch/kernels/qconv.py.
//
// qconv_int8, design "v2": the plan (tile, phases, split) is computed by
// kernels/qconv.py::qconv_plan and passed in; this file picks the tile's
// template instance. A phase is a stride-(sy, sx) conv over the undilated
// input that walks only the taps landing on input rows and columns, so a
// transposed conv's dilation holes are never loaded or multiplied. A stage
// is 64 bytes of K; each thread's 16-byte piece of it walks (tap, channel)
// by additions only. Shared rows are 64 bytes with their 16-byte chunks
// XOR-swizzled by (row / 2) % 4, so the cp.async stores and the
// ldmatrix.x4 loads (int8 m16n8k32 fragments as b16 8 x 8 matrices of
// 16-byte K rows) meet no bank conflict. The epilogue dequantizes in
// registers, writes the tile to shared memory over the ring, and stores
// each channel's runs of consecutive pixels as 16-byte vectors where Ho Wo
// is a multiple of the vector, else one element a thread along the pixels
// (along the channels for the fc's (N, Co)). A split K (the fc) adds int32
// partials into a zeroed workspace by atomics; the last block of a tile to
// arrive runs the epilogue. What bounds it, and each instance's registers
// and shared memory: kernels/qconv.py.
//
// Plain C interface for ctypes: every entry point launches on the caller's
// stream, allocates nothing, and returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;     // 8 warps, every quant_act kernel
constexpr int AMAX_PER_THREAD = 16;
constexpr int QT_PIX = 64;       // pixels of one quantize tile
constexpr int QT_CH = 32;        // channels of one quantize tile (= CP_ALIGN)
constexpr int CP_ALIGN = 32;     // channel padding of the int8 activations
constexpr int W_ROWS = 64;       // the packed weight's rows are padded to it
constexpr int BK = 64;           // K bytes of a conv stage: two k32 steps
constexpr int PIECES = BK / 16;  // 16-byte pieces of a stage's row
constexpr int STAGES = 4;        // cp.async ring depth
constexpr int EPAD = 8;          // elements padding a row of the output tile
constexpr int MAX_PHASES = 64;   // phases of one launch (dh * dw at most)
constexpr int MAX_DEVICES = 64;

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

// four 8 x 8 b16 matrices: lanes 8 j .. 8 j + 7 give the row addresses of
// matrix j, and lane l receives row l / 4, bytes 4 (l % 4) .. of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// float(acc) * scale (+ bias): a float32 output adds the bias in the same
// FMA (as XLA contracts the reference's dequantize and bias add); a
// bfloat16 output is rounded, then the bias added in bfloat16
__device__ __forceinline__ float dequant(float*, int acc, float scale,
                                         const float* bias) {
  const float v = __int2float_rn(acc);
  return bias ? __fmaf_rn(v, scale, *bias) : __fmul_rn(v, scale);
}
__device__ __forceinline__ __nv_bfloat16 dequant(__nv_bfloat16*, int acc,
                                                 float scale,
                                                 const float* bias) {
  __nv_bfloat16 r = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc),
                                                  scale));
  if (bias) r = __float2bfloat16_rn(__fadd_rn(__bfloat162float(r), *bias));
  return r;
}

// two adjacent elements (the first at an even index) as one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<uint2*>(p) = make_uint2(__float_as_uint(a),
                                            __float_as_uint(b));
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, __nv_bfloat16 a,
                                       __nv_bfloat16 b) {
  *reinterpret_cast<uint32_t*>(p) =
      (uint32_t)__bfloat16_as_ushort(a)
      | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// the 16-byte chunk c of a staged row r lies at chunk c ^ swizzle(r): the
// 8 rows r0 + 0..7 (r0 a multiple of 8) at one chunk meet the 8 distinct
// 16-byte bank groups of a 128-byte line (two 64-byte rows to a line)
__device__ __forceinline__ int swizzle(int r) { return (r >> 1) & 3; }

// One phase (ry, rx): the outputs (ry + ty jy, rx + tx jx), jy < ho,
// jx < wo. Output (jy, jx) reads input rows iy0 + sy jy + i for the taps
// ky = ky0 + dh i, i < nky (the same along x).
struct Phase {
  int ry, rx, ky0, kx0, nky, nkx, iy0, ix0, ho, wo;
};

struct Conv {
  int n, h, w, cp, co, ho, wo, kw, dh, dw;
  long long ktot;        // kh kw cp: a packed weight row
  int ty, tx, sy, sx;    // output period of the phases, their input step
  int nph, ntm, ntp;     // phases, channel tiles, pixel tiles (the largest)
  int splits, kt_per;    // K slices, stages of a slice
  Phase phase[MAX_PHASES];
};

template <int BM, int BN>
struct Tile {
  static constexpr int WM = BM == 128 ? 64 : 32;  // a warp's rows
  static constexpr int WN = BN == 256 ? 64 : 32;  // a warp's columns
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
  static constexpr int RING = STAGES * (BM + BN) * BK;
  static constexpr int COLS = BN * 24 + 16;  // column tables, arrival flag
  template <typename OUT>
  __host__ __device__ static constexpr int smem() {
    return (RING > BM * (BN + EPAD) * (int)sizeof(OUT)
                ? RING : BM * (BN + EPAD) * (int)sizeof(OUT)) + COLS;
  }
};

// y = dequant(conv(xq, wp)) for one (channel tile, phase, pixel tile) and
// one K slice (blockIdx.z). GEMM rows M = output channels (wp (co rounded
// up to 64, ktot) row-major, K = (ky, kx, ci), ci over cp), columns N = the
// phase's output pixels over the batch, K = the phase's taps x cp in
// stages of BK bytes. Warp (wm, wn) owns WM x WN: WM / 16 x WN / 8 tiles
// of mma.m16n8k32 s8 -> s32. Thread t copies the 16-byte piece t % PIECES
// of rows t / PIECES + i THREADS / PIECES of A and B each stage,
// zero-filled where the tap falls on padding or past the phase's K.
template <int BM, int BN, int BF16>
__global__ void __launch_bounds__(Tile<BM, BN>::THREADS,
                                  512 / Tile<BM, BN>::THREADS)  // 128 regs
qconv(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
      const float* __restrict__ sx, const float* __restrict__ swt,
      const float* __restrict__ bias,
      std::conditional_t<BF16 != 0, __nv_bfloat16, float>* __restrict__ y,
      int* __restrict__ ws, const __grid_constant__ Conv g) {
  using OUT = std::conditional_t<BF16 != 0, __nv_bfloat16, float>;
  using T = Tile<BM, BN>;
  constexpr int THREADS_ = T::THREADS, MI = T::WM / 16, NI = T::WN / 8;
  constexpr int ROWS = THREADS_ / PIECES;  // rows of one copy pass
  constexpr int PITCH = BN + EPAD;         // elements of an output tile row
  constexpr int V = 16 / (int)sizeof(OUT);  // elements of a vector store
  static_assert(ROWS % 8 == 0 && PITCH * sizeof(OUT) % 16 == 0, "");
  constexpr int A_ROWS = BM / ROWS, B_ROWS = BN / ROWS;
  constexpr int STAGE = (BM + BN) * BK;
  constexpr int MAIN = T::template smem<OUT>() - T::COLS;
  extern __shared__ __align__(128) uint8_t smem[];
  long long* const col_out = reinterpret_cast<long long*>(smem + MAIN);
  int* const col_in = reinterpret_cast<int*>(col_out + BN);
  int* const col_iy = col_in + BN;
  int* const col_ix = col_iy + BN;
  float* const col_sx = reinterpret_cast<float*>(col_ix + BN);
  int* const last = reinterpret_cast<int*>(col_sx + BN);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int bid = blockIdx.x;
  const int mt = bid % g.ntm;
  bid /= g.ntm;
  const int pt = bid / g.nph;
  const Phase& f = g.phase[bid - pt * g.nph];
  const int hw = f.ho * f.wo, P = g.n * hw;
  const int p0 = pt * BN, m0 = mt * BM;
  if (p0 >= P) return;
  const long long howo = (long long)g.ho * g.wo;

  // the tile's columns (output pixels): offset of channel 0 in y, offset
  // of the sample in x, first input row and column, sx[n]
  for (int c = tid; c < BN; c += THREADS_) {
    const int p = p0 + c;
    long long out = 0;
    int in = 0, iy = -(1 << 30), ix = -(1 << 30);  // no tap lands
    float s = 0.f;
    if (p < P) {
      const int n = p / hw, r = p - n * hw, jy = r / f.wo, jx = r - jy * f.wo;
      out = (long long)n * g.co * howo
            + (f.ry + g.ty * jy) * g.wo + f.rx + g.tx * jx;
      in = n * g.h * g.w * g.cp;
      iy = f.iy0 + g.sy * jy;
      ix = f.ix0 + g.sx * jx;
      s = sx[n];
    }
    col_out[c] = out;
    col_in[c] = in;
    col_iy[c] = iy;
    col_ix[c] = ix;
    col_sx[c] = s;
  }
  __syncthreads();

  // this thread's copies: piece q of A rows and B rows row0 + i ROWS
  const int q = tid % PIECES, row0 = tid / PIECES;
  const int chunk = 16 * (q ^ swizzle(row0));  // ROWS % 8 == 0
  const int8_t* const a_src = wp + (long long)(m0 + row0) * g.ktot;
  int xo[B_ROWS], iy0[B_ROWS], ix0[B_ROWS];  // xo: offset of tap (0, 0)
#pragma unroll
  for (int i = 0; i < B_ROWS; ++i) {
    const int c = row0 + i * ROWS;
    iy0[i] = col_iy[c];
    ix0[i] = col_ix[c];
    xo[i] = p0 + c < P ? col_in[c] + (iy0[i] * g.w + ix0[i]) * g.cp : 0;
  }

  // this block's stages [kt0, kt0 + nkt) of the phase's K; the piece's
  // tap (ty, tx) and channel ci, advanced by additions
  const int kt_all = (f.nky * f.nkx * g.cp + BK - 1) / BK;
  const int kt0 = blockIdx.z * g.kt_per;
  const int nkt = max(0, min(kt_all, kt0 + g.kt_per) - kt0);
  int ty = 0, tx = 0, ci = 0;
  if (nkt > 0) {
    const int k = kt0 * BK + 16 * q, t = k / g.cp;
    ci = k - t * g.cp;
    ty = t / f.nkx;
    tx = t - ty * f.nkx;
  }
  auto load = [&](int slot) {
    uint8_t* const as = smem + slot * STAGE;
    uint8_t* const bs = as + BM * BK;
    const bool kin = ty < f.nky;
    const long long a_off =
        kin ? ((long long)(f.ky0 + g.dh * ty) * g.kw + f.kx0 + g.dw * tx)
                  * g.cp + ci
            : 0;
    const int b_off = (ty * g.w + tx) * g.cp + ci;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i)
      cp_async16(as + (row0 + i * ROWS) * BK + chunk,
                 a_src + i * ROWS * g.ktot + a_off, kin);
#pragma unroll
    for (int i = 0; i < B_ROWS; ++i) {
      const int iy = iy0[i] + ty, ix = ix0[i] + tx;
      const bool ok = kin && (unsigned)iy < (unsigned)g.h
                      && (unsigned)ix < (unsigned)g.w;
      cp_async16(bs + (row0 + i * ROWS) * BK + chunk,
                 x + (ok ? xo[i] + b_off : 0), ok);
    }
    ci += BK;
    while (ci >= g.cp) {
      ci -= g.cp;
      if (++tx == f.nkx) {
        tx = 0;
        ++ty;
      }
    }
  };

  // fragments: A rows wm WM + mi 16 + (l % 8) + 8 ((l / 8) % 2), chunk
  // l / 16; B rows wn WN + nj 16 + (l % 8) + 8 (l / 16), chunk (l / 8) % 2,
  // of each k32 step. Rows 8 apart share a swizzle.
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int lsw = swizzle(lane & 7);
  const int a_row = wm * T::WM + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int b_row = wn * T::WN + (lane & 7) + 8 * (lane >> 4);
  const int a_hi = lane >> 4, b_hi = (lane >> 3) & 1;

  int acc[MI][NI][4] = {};
  int wslot = 0, rslot = 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load(wslot);
    cp_async_commit();
    wslot = wslot + 1 == STAGES ? 0 : wslot + 1;
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nkt) load(wslot);
    cp_async_commit();
    wslot = wslot + 1 == STAGES ? 0 : wslot + 1;
    const uint8_t* const as = smem + rslot * STAGE;
    const uint8_t* const bs = as + BM * BK;
    rslot = rslot + 1 == STAGES ? 0 : rslot + 1;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t b[NI][2];
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (b_row + 16 * nj) * BK
                           + 16 * ((2 * kk + b_hi) ^ lsw));
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t a[4];
        ldmatrix_x4(a, as + (a_row + 16 * mi) * BK
                           + 16 * ((2 * kk + a_hi) ^ lsw));
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a, b[ni]);
      }
    }
  }
  cp_async_wait<0>();

  // fragment (mi, ni, e) is tile row wm WM + mi 16 + l / 4 + 8 (e / 2),
  // column wn WN + ni 8 + 2 (l % 4) + e % 2
  const int fr = wm * T::WM + (lane >> 2), fc = wn * T::WN + 2 * (lane & 3);
  if (g.splits > 1) {
    // add the partial sums into the tile's int32 workspace; the last of
    // the splits blocks to arrive reads the whole sums back
    const int tile = blockIdx.x;
    int* const part = ws + (long long)tile * BM * BN;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          atomicAdd(part + (fr + 16 * mi + 8 * (e >> 1)) * BN + fc + 8 * ni
                        + (e & 1),
                    acc[mi][ni][e]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* const arrived = ws + (long long)g.ntm * g.nph * g.ntp * BM * BN;
      *last = atomicAdd(arrived + tile, 1) == g.splits - 1;
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][ni][e] = __ldcg(part + (fr + 16 * mi + 8 * (e >> 1)) * BN
                                  + fc + 8 * ni + (e & 1));
  }
  __syncthreads();  // the ring is free

  // dequantize into the output tile [BM][PITCH] over the ring, two
  // columns to a store
  float csx[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) csx[ni][j] = col_sx[fc + 8 * ni + j];
  OUT* const tile = reinterpret_cast<OUT*>(smem);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = fr + 16 * mi + 8 * h, co = m0 + r;
      if (co >= g.co) continue;
      const float s_w = swt[co];
      const float* const b = bias ? bias + co : nullptr;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        store2(tile + r * PITCH + fc + 8 * ni,
               dequant(tile, acc[mi][ni][2 * h],
                       __fmul_rn(csx[ni][0], s_w), b),
               dequant(tile, acc[mi][ni][2 * h + 1],
                       __fmul_rn(csx[ni][1], s_w), b));
    }
  __syncthreads();

  // the stores, all threads over (row, column) of the tile
  const int rows = min(BM, g.co - m0), valid = min(BN, P - p0);
  if (howo == 1) {  // (n, co): consecutive threads along the channels
    for (int i = tid; i < BM * BN; i += THREADS_) {
      const int c = i / BM, r = i - c * BM;
      if (r < rows && c < valid)
        y[col_out[c] + m0 + r] = tile[r * PITCH + c];
    }
  } else if (g.ty == 1 && g.tx == 1 && howo % V == 0) {
    // a sample's pixels start at a multiple of V in y and in the tile
    // (p0 and howo are): 16-byte vectors of V consecutive pixels
    for (int i = tid; i < rows * (BN / V); i += THREADS_) {
      const int r = i / (BN / V), c = (i - r * (BN / V)) * V;
      const long long o = col_out[c] + (long long)(m0 + r) * howo;
      const OUT* const src = tile + r * PITCH + c;
      if (c + V <= valid) {
        *reinterpret_cast<uint4*>(y + o) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; c + j < valid; ++j) y[o + j] = src[j];
      }
    }
  } else {  // consecutive threads along the pixels
    for (int i = tid; i < rows * BN; i += THREADS_) {
      const int r = i / BN, c = i - r * BN;
      if (c < valid)
        y[col_out[c] + (long long)(m0 + r) * howo] = tile[r * PITCH + c];
    }
  }
}

template <int BM, int BN, int BF16>
cudaError_t launch_qconv(const int8_t* x, const int8_t* wp, const float* sx,
                         const float* sw, const float* bias, void* y,
                         int* ws, const Conv& g, cudaStream_t s) {
  using OUT = std::conditional_t<BF16 != 0, __nv_bfloat16, float>;
  constexpr int SMEM = Tile<BM, BN>::template smem<OUT>();
  // once a device and process, at the first call (before any capture)
  static bool attribute_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!attribute_set[dev]) {
    err = cudaFuncSetAttribute(qconv<BM, BN, BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return err;
    attribute_set[dev] = true;
  }
  const dim3 grid((unsigned)g.ntm * g.nph * g.ntp, 1, g.splits);
  qconv<BM, BN, BF16><<<grid, Tile<BM, BN>::THREADS, SMEM, s>>>(
      x, wp, sx, sw, bias, static_cast<OUT*>(y), ws, g);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_tile(int bf16, const int8_t* x, const int8_t* wp,
                        const float* sx, const float* sw, const float* bias,
                        void* y, int* ws, const Conv& g, cudaStream_t s) {
  return bf16 ? launch_qconv<BM, BN, 1>(x, wp, sx, sw, bias, y, ws, g, s)
              : launch_qconv<BM, BN, 0>(x, wp, sx, sw, bias, y, ws, g, s);
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
// (bf16 == 0) or bfloat16, 16-byte aligned. Stride (sh, sw), padding (ph,
// pw) on the top and left of the input dilated by (dh, dw); the bottom and
// right follow from (ho, wo). `plan` (host memory, kernels/qconv.py::
// QConvPlan.array): bm, bn, splits, kt_per, ty, tx, sy, sx, nph, ntm, ntp,
// then (ry, rx, ky0, kx0, nky, nkx, iy0, ix0, ho, wo) per phase. ws: with
// splits > 1, ntm nph ntp (bm bn + 1) int32 that this call zeroes, else
// unused.
int qconv_int8(const void* xq, const void* wp, const void* sx,
               const void* sw, const void* bias, void* y, void* ws,
               const void* plan, int n, int h, int w, int cp, int co,
               int ho, int wo, int kh, int kw, int sh, int swd, int ph,
               int pw, int dh, int dw, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pl = static_cast<const int*>(plan);
  const int bm = pl[0], bn = pl[1];
  Conv g{};
  g.n = n, g.h = h, g.w = w, g.cp = cp, g.co = co, g.ho = ho, g.wo = wo;
  g.kw = kw, g.dh = dh, g.dw = dw, g.ktot = (long long)kh * kw * cp;
  g.splits = pl[2], g.kt_per = pl[3], g.ty = pl[4], g.tx = pl[5];
  g.sy = pl[6], g.sx = pl[7], g.nph = pl[8], g.ntm = pl[9], g.ntp = pl[10];
  const long long blocks = (long long)g.ntm * g.nph * g.ntp;
  bool ok = n >= 1 && h >= 1 && w >= 1 && co >= 1 && ho >= 1 && wo >= 1
            && kh >= 1 && kw >= 1 && sh >= 1 && swd >= 1 && dh >= 1
            && dw >= 1 && ph >= 0 && pw >= 0 && cp % CP_ALIGN == 0
            && cp >= CP_ALIGN && g.nph >= 1 && g.nph <= MAX_PHASES
            && g.splits >= 1 && g.splits <= 65535 && g.kt_per >= 1
            && g.ty >= 1 && g.tx >= 1 && g.sy >= 1 && g.sx >= 1
            && g.ntp >= 1 && blocks <= 0x7fffffffLL
            // the tile's rows stay within the packed weight's
            && g.ntm == (co + bm - 1) / bm
            && (long long)g.ntm * bm <= (co + W_ROWS - 1) / W_ROWS * W_ROWS
            // sample offsets of x fit an int
            && (long long)n * h * w * cp <= 0x7fffffffLL
            && (g.splits == 1 || ws != nullptr)
            && reinterpret_cast<uintptr_t>(xq) % 16 == 0
            && reinterpret_cast<uintptr_t>(wp) % 16 == 0
            && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  for (int i = 0; ok && i < g.nph; ++i) {
    const int* r = pl + 11 + 10 * i;
    Phase& f = g.phase[i];
    f = Phase{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9]};
    // taps within the kernel, outputs within (ho, wo), pixels within the
    // pixel tiles
    ok = f.ry >= 0 && f.rx >= 0 && f.ho >= 1 && f.wo >= 1
         && f.nky >= 0 && f.nkx >= 0 && f.ky0 >= 0 && f.kx0 >= 0
         && (f.nky == 0 || f.ky0 + (long long)dh * (f.nky - 1) < kh)
         && (f.nkx == 0 || f.kx0 + (long long)dw * (f.nkx - 1) < kw)
         && f.ry + (long long)g.ty * (f.ho - 1) < ho
         && f.rx + (long long)g.tx * (f.wo - 1) < wo
         && (long long)n * f.ho * f.wo <= (long long)g.ntp * bn
         && (long long)n * f.ho * f.wo <= 0x7fffffffLL;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  int* wsp = static_cast<int*>(ws);
  if (g.splits > 1) {
    const cudaError_t err = cudaMemsetAsync(
        wsp, 0, sizeof(int) * blocks * (bm * bn + 1), s);
    if (err != cudaSuccess) return (int)err;
  }
  const auto* xp = static_cast<const int8_t*>(xq);
  const auto* wq = static_cast<const int8_t*>(wp);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  const auto* bp = static_cast<const float*>(bias);
  cudaError_t err = cudaErrorInvalidValue;
  if (bm == 32 && bn == 64)
    err = launch_tile<32, 64>(bf16, xp, wq, sxp, swp, bp, y, wsp, g, s);
  else if (bm == 32 && bn == 128)
    err = launch_tile<32, 128>(bf16, xp, wq, sxp, swp, bp, y, wsp, g, s);
  else if (bm == 64 && bn == 64)
    err = launch_tile<64, 64>(bf16, xp, wq, sxp, swp, bp, y, wsp, g, s);
  else if (bm == 64 && bn == 128)
    err = launch_tile<64, 128>(bf16, xp, wq, sxp, swp, bp, y, wsp, g, s);
  else if (bm == 128 && bn == 64)
    err = launch_tile<128, 64>(bf16, xp, wq, sxp, swp, bp, y, wsp, g, s);
  else if (bm == 128 && bn == 128)
    err = launch_tile<128, 128>(bf16, xp, wq, sxp, swp, bp, y, wsp, g, s);
  else if (bm == 64 && bn == 256)
    err = launch_tile<64, 256>(bf16, xp, wq, sxp, swp, bp, y, wsp, g, s);
  return (int)err;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
