// int8 post-training quantization for Hopper (sm_90a): the dynamic
// per-sample activation quantizer and the int8 implicit-GEMM convolution
// with int32 accumulators and a per-sample x per-channel dequantizing
// epilogue. They run the convolutions and the fc that
// msml_tpu/core/quantize.py rewrites to int8 (there XLA lowers them); the
// design notes are in msml_torch/kernels/qconv.py.
//
// quant_act, design "v2": one launch, one thread-block cluster of K blocks
// per sample (the plan, kernels/qconv.py::quant_act_plan, picks K and the
// pixels P of a block). Block k stages pixels [k P, (k + 1) P) of every
// channel in shared memory once (16-byte cp.async of the aligned windows
// that cover each row, so that a row lies in shared memory at its global
// address modulo 16), takes its abs-max, and the cluster exchanges the blocks' maxima through
// distributed shared memory: no atomics, no workspace, the same maximum
// in any order. The codes are then built from shared memory, one 16-byte
// piece (16 channels of one pixel) a thread, and written with one 16-byte
// store. A sample too large for 16 blocks' shared memory keeps the first
// design's two passes (act_amax, then act_quant).
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;     // 8 warps, the two-pass kernels
constexpr int CT = 512;          // threads of a quant_act cluster block
constexpr int CWARPS = CT / 32;
constexpr int SKEW = 64;         // bytes between two 16-channel groups' rows
constexpr int SCRATCH = 128;     // bytes after the staged data: the warps'
                                 // maxima, then the block's
constexpr int MAX_CLUSTER = 16;  // blocks of a cluster (non-portable > 8)
constexpr int MAX_SMEM = 232448; // an H100 block's opt-in shared memory
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

// A sample's scale s as the codes divide by it: s and y = RN(1 / s); an
// infinite s (an infinite input) as (FLT_MAX, 0), which gives v / s's 0
// for a finite v and NaN for an infinite one, as IEEE division does
struct Divisor {
  float s, y;
};
__device__ __forceinline__ Divisor divisor(float s) {
  return isinf(s) ? Divisor{3.402823466e38f, 0.f}
                  : Divisor{s, __frcp_rn(s)};
}

// clip(rint(v / s), -127, 127) in the low byte of the returned bits (the
// rest is not zero): v / s as IEEE division rounds it, from q = RN(v y)
// and one FMA (Markstein: the residual v - s q is exact, and RN(q + (v -
// s q) y) is the correctly rounded quotient; a quotient too small for
// that rounds to code 0 either way), then the clip and rint by adding 1.5
// 2^23 (round half to even, as rintf; the low byte is then the code).
// Five FMA-pipe instructions: IEEE division, rintf and the conversion to
// an integer would each take the 16-lane conversion pipe, which bound the
// first design (tests/test_torch_quant_act_plan.py holds the two equal).
__device__ __forceinline__ uint32_t code_bits(float v, Divisor d) {
  const float q = __fmul_rn(v, d.y);
  const float t = __fmaf_rn(__fmaf_rn(-q, d.s, v), d.y, q);
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(t, -127.f), 127.f), 12582912.f));
}

// the low bytes of a, b, c, d as one little-endian word
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
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
  const Divisor d = divisor(s);
  const int t = threadIdx.x, p = t % QT_PIX, g = t / QT_PIX;
  const T* xn = x + (size_t)n * c * hw;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = c0 + 16 * half + 4 * g + i;
      float v = 0.f;
      if (ch < c && p0 + p < hw) v = to_f32(xn[(size_t)ch * hw + p0 + p]);
      b[i] = code_bits(v, d);
    }
    tile[p * 9 + 4 * half + g] = pack4(b[0], b[1], b[2], b[3]);
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

__host__ __device__ inline long long round16(long long v) {
  return (v + 15) / 16 * 16;
}

// Bytes of a quant_act cluster block's dynamic shared memory (the plan's,
// kernels/qconv.py::act_smem). hw == 1 (the fc's (n, c)): the sample's c
// elements at their global address modulo 16. Else c rows of rowb bytes,
// each 16-channel group SKEW bytes after the previous one's end (row ch at
// ch rowb + SKEW (ch / 16)), each row holding the block's pixels at their
// global address modulo 16; then the rows' offsets (an int each). Then
// SCRATCH.
__host__ __device__ inline long long act_smem(int c, int hw, int rowb,
                                              int esize) {
  if (hw == 1) return round16((long long)c * esize) + 16 + SCRATCH;
  return (long long)c * rowb + SKEW * ((c - 1) >> 4) + round16(4LL * c)
         + SCRATCH;
}

// max(m, |v|) over the 16 bytes at p, T elements
__device__ __forceinline__ float max16(const uint8_t* p, float m, float*) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return fmaxf(fmaxf(fmaxf(m, fabsf(v.x)), fmaxf(fabsf(v.y), fabsf(v.z))),
               fabsf(v.w));
}
__device__ __forceinline__ __nv_bfloat162 abs2(uint32_t w) {
  const uint32_t a = w & 0x7fff7fffu;
  return *reinterpret_cast<const __nv_bfloat162*>(&a);
}
// bf16: pairs by __hmax2, which like fmaxf drops a NaN for the other input
__device__ __forceinline__ float max16(const uint8_t* p, float m,
                                       __nv_bfloat16*) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162 h = __hmax2(__hmax2(abs2(v.x), abs2(v.y)),
                                   __hmax2(abs2(v.z), abs2(v.w)));
  return fmaxf(m, fmaxf(__low2float(h), __high2float(h)));
}

// max(m, |v|) over the T elements of the 16 bytes at p whose bytes lie in
// [lo, hi) (byte offsets within the 16)
template <typename T>
__device__ __forceinline__ float max16_in(const uint8_t* p, float m, int lo,
                                          int hi) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < 16; b += (int)sizeof(T)) {
    const uint32_t word = w[b >> 2];
    const float e = sizeof(T) == 4 ? __uint_as_float(word)
                    : __uint_as_float((b & 2) ? word & 0xffff0000u
                                              : word << 16);
    if (b >= lo && b < hi) m = fmaxf(m, fabsf(e));
  }
  return m;
}

// The 16 codes of channels cb .. cb + 15 (zero from c on, nv real ones)
// of one pixel, packed little-endian: channel cb + j's element at at(j)
template <typename T, bool FULL, typename At>
__device__ __forceinline__ uint4 piece(At at, int nv, Divisor d) {
  uint32_t b[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float v = 0.f;
    if (FULL || j < nv) v = to_f32(*reinterpret_cast<const T*>(at(j)));
    b[j] = code_bits(v, d);
  }
  return make_uint4(pack4(b[0], b[1], b[2], b[3]),
                    pack4(b[4], b[5], b[6], b[7]),
                    pack4(b[8], b[9], b[10], b[11]),
                    pack4(b[12], b[13], b[14], b[15]));
}

// quant_act's cluster route: block k of sample n (cluster rank k of K =
// gridDim.x, blockIdx.y = n) owns pixels [k p, min(hw, (k + 1) p)).
//  1. Stage: row ch (the flat sample: one row of c elements) is bytes
//     [g0, g0 + bytes) of x; its 16-byte windows (g0 & ~15) + 16 i go
//     whole by cp.async to the row's base + 16 i, so that the row starts
//     at g0's address modulo 16 (the table keeps where). A window
//     straddling the row's ends is 16-byte aligned, so it lies in one page
//     with the row's bytes; its other bytes are never read as data. A row
//     is taken by a group of lanes, the least power of two that covers its
//     windows (at most a warp; the flat sample by all threads). Then each
//     thread's max |v| over the row bytes of the windows it copied.
//  2. Reduce: warp shuffles, the block's warps through shared memory, and
//     with K > 1 every block's maximum read by each warp through
//     distributed shared memory after one cluster barrier. Block 0 writes
//     sx[n].
//  3. Codes: a warp takes 16 pixels x 32 channels, lane (pixel l % 16,
//     channels 16 (l / 16) ..); at each of 16 steps the two half-warps read
//     16 consecutive pixels of channels 16 apart, whose rows SKEW puts 64
//     bytes apart modulo 128 (16 rowb is a multiple of 256): no bank
//     conflict, and the two 16-byte pieces of a pixel make one 32-byte
//     sector of xq. hw == 1: thread g builds piece g of the (n, cp) row;
//     lane l reads channel 16 g + (j + r) % 16 at step j (r = l / 2, bf16
//     2 (l / 4): 32 distinct banks) and rotates the piece back by r bytes.
template <typename T>
__global__ void __launch_bounds__(CT, 2)
act_cluster(const T* __restrict__ x, int8_t* __restrict__ xq,
            float* __restrict__ sx, int c, int hw, int cp, int p,
            int rowb) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int ES = sizeof(T);
  const int k = blockIdx.x, K = gridDim.x, n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool flat = hw == 1;
  const int p0 = k * p, L = max(0, min(hw, p0 + p) - p0);
  const uint8_t* const xn =
      reinterpret_cast<const uint8_t*>(x + (size_t)n * c * hw);
  const int rows_end = c * rowb + SKEW * ((c - 1) >> 4);
  int* const table = reinterpret_cast<int*>(smem + rows_end);
  float* const slots = reinterpret_cast<float*>(
      smem + (flat ? (int)round16(c * ES) + 16
                   : rows_end + (int)round16(4 * c)));
  const int bytes = (flat ? c : L) * ES;  // a row's
  // a row's lanes (the flat sample's: all threads), and which row group
  // and lane of it this thread is
  const int windows = flat ? CT : rowb / 16;
  const int lanes = flat ? CT
                    : windows <= 1 ? 1 : min(32, 1 << (32 - __clz(windows - 1)));
  const int groups = CT / lanes, grp = tid / lanes, gl = tid - grp * lanes;
  const int rows = bytes > 0 ? (flat ? 1 : c) : 0;
  auto row_src = [&](int ch) {
    return flat ? xn : xn + ((size_t)ch * hw + p0) * ES;
  };
  auto row_base = [&](int ch) {
    return flat ? 0 : ch * rowb + SKEW * (ch >> 4);
  };

  // 1. stage, then the max of the row bytes of the windows this thread
  // copied
  for (int ch = grp; ch < rows; ch += groups) {
    const uint8_t* const g0 = row_src(ch);
    const int a = static_cast<int>(reinterpret_cast<uintptr_t>(g0) & 15);
    uint8_t* const dst = smem + row_base(ch);
    if (gl == 0 && !flat) table[ch] = row_base(ch) + a;
    for (int i = gl; 16 * i < a + bytes; i += lanes)
      cp_async16(dst + 16 * i, g0 - a + 16 * i, true);
  }
  // this thread's copies have landed (the clobber keeps the reads below)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  float m = 0.f;
  for (int ch = grp; ch < rows; ch += groups) {
    const int a = static_cast<int>(
        reinterpret_cast<uintptr_t>(row_src(ch)) & 15);
    const uint8_t* const src = smem + row_base(ch);
    for (int i = gl; 16 * i < a + bytes; i += lanes) {
      const int lo = a - 16 * i, hi = a + bytes - 16 * i;  // the row's bytes
      m = lo <= 0 && hi >= 16
          ? max16(src + 16 * i, m, static_cast<T*>(nullptr))
          : max16_in<T>(src + 16 * i, m, lo, hi);
    }
  }

  // 2. the sample's abs-max
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) slots[warp] = m;
  __syncthreads();  // the slots, the table and every staged byte
  if (warp == 0) {
    float v = lane < CWARPS ? slots[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) slots[CWARPS] = v;
  }
  float amax;
  if (K > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's maximum is in its slot
    amax = lane < K ? *cluster.map_shared_rank(slots + CWARPS, lane) : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    // done with the peers' slots; the matching wait comes before the
    // exit, so no block leaves while a peer may still read its slot
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
    amax = slots[CWARPS];
  }
  const float scale = fmaxf(__fmul_rn(amax, inv_qmax()), 1e-12f);
  if (k == 0 && tid == 0) sx[n] = scale;
  const Divisor d = divisor(scale);

  // 3. the codes, 16-byte pieces
  if (flat) {
    // lane l reads its piece's channels from the r-th on: r = l / 2 for
    // float32, 2 (l / 4) for bf16 (its two elements a word), whatever the
    // sample's start modulo 16: 32 distinct banks at every step
    const int r = (lane / (8 / ES)) * (4 / ES), kw = r >> 2, sh = 8 * (r & 3);
    const uint8_t* const row =
        smem + static_cast<int>(reinterpret_cast<uintptr_t>(xn) & 15);
    int8_t* const out = xq + (size_t)n * cp;
    for (int g = tid; g < (cp >> 4); g += CT) {
      int off[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) off[j] = (16 * g + ((j + r) & 15)) * ES;
      const int nv = c - 16 * g;
      // byte j: channel 16 g + (j + r) % 16 (nv counts the real ones from
      // channel 16 g, which the rotation scatters: test each)
      uint32_t bits[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float v = ((j + r) & 15) < nv
            ? to_f32(*reinterpret_cast<const T*>(row + off[j])) : 0.f;
        bits[j] = code_bits(v, d);
      }
      // rotate the 16 bytes up by r: words by r / 4, then bytes by r % 4
      uint32_t x0 = pack4(bits[0], bits[1], bits[2], bits[3]);
      uint32_t x1 = pack4(bits[4], bits[5], bits[6], bits[7]);
      uint32_t x2 = pack4(bits[8], bits[9], bits[10], bits[11]);
      uint32_t x3 = pack4(bits[12], bits[13], bits[14], bits[15]);
      if (kw & 1) {
        const uint32_t t = x3;
        x3 = x2;
        x2 = x1;
        x1 = x0;
        x0 = t;
      }
      if (kw & 2) {
        uint32_t t = x0;
        x0 = x2;
        x2 = t;
        t = x1;
        x1 = x3;
        x3 = t;
      }
      *reinterpret_cast<uint4*>(out + 16 * g) = make_uint4(
          __funnelshift_l(x3, x0, sh), __funnelshift_l(x0, x1, sh),
          __funnelshift_l(x1, x2, sh), __funnelshift_l(x2, x3, sh));
    }
  } else {
    const int pl = lane & 15, gl2 = lane >> 4;
    const int npb = (L + 15) >> 4, g2 = cp >> 5;
    int8_t* const out = xq + ((size_t)n * hw + p0) * cp;
    // every row of the block at one address modulo 16 (hw and p whole
    // 16-byte multiples): channel cb + j at the group's first row + j rowb;
    // else the table's offsets
    const bool even = (hw * ES) % 16 == 0 && (p * ES) % 16 == 0;
    const int a0 = static_cast<int>(
        reinterpret_cast<uintptr_t>(row_src(0)) & 15);
    int cur = -1, off[16];
    for (int t = warp; t < npb * g2; t += CWARPS) {
      const int pb = t / g2, gp = t - pb * g2;
      const int cb = 32 * gp + 16 * gl2, nv = c - cb;
      const int pix = 16 * pb + pl;
      if (pix >= L) continue;
      uint4 codes;
      if (even) {
        const uint8_t* const first = smem + row_base(cb) + a0 + pix * ES;
        auto at = [&](int j) { return first + j * rowb; };
        codes = nv >= 16 ? piece<T, true>(at, nv, d)
                         : piece<T, false>(at, nv, d);
      } else {
        if (gp != cur) {  // a warp keeps its channels while g2 divides
          cur = gp;       // CWARPS
#pragma unroll
          for (int j = 0; j < 16; ++j) off[j] = j < nv ? table[cb + j] : 0;
        }
        auto at = [&](int j) { return smem + off[j] + pix * ES; };
        codes = nv >= 16 ? piece<T, true>(at, nv, d)
                         : piece<T, false>(at, nv, d);
      }
      *reinterpret_cast<uint4*>(out + (size_t)pix * cp + cb) = codes;
    }
  }
  if (K > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// act_cluster's attributes, once a device and process at its first use
// (before any capture): all of a block's shared memory, clusters of 16
template <typename T>
cudaError_t cluster_attributes() {
  static bool attribute_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (attribute_set[dev]) return cudaSuccess;
  if ((err = cudaFuncSetAttribute(act_cluster<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  MAX_SMEM)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(
           act_cluster<T>, cudaFuncAttributeNonPortableClusterSizeAllowed,
           1)) != cudaSuccess)
    return err;
  attribute_set[dev] = true;
  return cudaSuccess;
}

cudaLaunchConfig_t cluster_config(int n, int k, int smem,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, n);
  cfg.blockDim = dim3(CT);
  cfg.dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = k > 1 ? 1 : 0;  // a block alone needs no cluster
  return cfg;
}

template <typename T>
cudaError_t launch_cluster(const T* x, int8_t* xq, float* sx, int n, int c,
                           int hw, int cp, const int* plan, cudaStream_t s) {
  cudaError_t err = cluster_attributes<T>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(n, plan[0], plan[3], &attr);
  cfg.stream = s;
  if ((err = cudaLaunchKernelEx(&cfg, act_cluster<T>, x, xq, sx, c, hw, cp,
                                plan[1], plan[2])) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t cluster_occupancy(int k, int smem, int* clusters,
                              int* blocks_per_sm) {
  cudaError_t err = cluster_attributes<T>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, k, smem, &attr);
  cfg.numAttrs = 1;  // the query wants a cluster shape, k = 1 too
  if ((err = cudaOccupancyMaxActiveClusters(clusters, act_cluster<T>,
                                            &cfg)) != cudaSuccess)
    return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, act_cluster<T>, CT, smem);
}

}  // namespace

extern "C" {

// (xq, sx) = quant_act(x): x (n, c, hw) float32 (bf16 == 0) or bfloat16,
// xq int8 (n, hw, cp), cp a multiple of 32 >= c, 16-byte aligned; sx (n,)
// float32. `plan` (host memory, kernels/qconv.py::ActPlan.array): k, p,
// rowb, smem. k >= 1: the cluster route, one launch of n clusters of k
// blocks, each owning p pixels, with rows of rowb bytes and smem bytes of
// shared memory (act_smem's); amax is not used. k == 0: the two-pass
// route, amax (n,) unsigned a workspace this call zeroes.
int quant_act(const void* x, void* xq, void* sx, void* amax,
              const void* plan, int n, int c, int hw, int cp, int bf16,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pl = static_cast<const int*>(plan);
  const int k = pl[0], p = pl[1], rowb = pl[2], smem = pl[3];
  const int esize = bf16 ? 2 : 4;
  if (n < 1 || n > 65535 || c < 1 || hw < 1 || cp % CP_ALIGN != 0 ||
      cp < c || reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % esize != 0)
    return (int)cudaErrorInvalidValue;
  auto* q = static_cast<int8_t*>(xq);
  auto* scale = static_cast<float*>(sx);
  cudaError_t err;
  if (k == 0) {
    if (amax == nullptr || cp / QT_CH > 65535)
      return (int)cudaErrorInvalidValue;
    auto* am = static_cast<unsigned*>(amax);
    if ((err = cudaMemsetAsync(am, 0, sizeof(unsigned) * n, s)) !=
        cudaSuccess)
      return (int)err;
    const long long per = (long long)c * hw;
    const dim3 agrid((unsigned)((per + THREADS * AMAX_PER_THREAD - 1)
                                / (THREADS * AMAX_PER_THREAD)), n);
    const dim3 qgrid((hw + QT_PIX - 1) / QT_PIX, cp / QT_CH, n);
#define TWO_PASS(T)                                                          \
  act_amax<T><<<agrid, THREADS, 0, s>>>(static_cast<const T*>(x), am, per); \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;           \
  act_quant<T><<<qgrid, THREADS, 0, s>>>(static_cast<const T*>(x), q, scale, \
                                         am, c, hw, cp)
    if (bf16) {
      TWO_PASS(__nv_bfloat16);
    } else {
      TWO_PASS(float);
    }
#undef TWO_PASS
    return (int)cudaGetLastError();
  }
  // the plan's layout: every pixel owned by one block, rows that hold a
  // block's pixels wherever they start modulo 16, the shared memory
  // act_smem gives, the fc's input flat in one block
  if ((k & (k - 1)) != 0 || k > MAX_CLUSTER || p < 1 ||
      (long long)k * p < hw ||
      (hw == 1 && (k != 1 || rowb != 0)) ||
      (hw > 1 && (rowb % 16 != 0 ||
                   rowb < round16((long long)p * esize) + 16)) ||
      smem > MAX_SMEM || smem != act_smem(c, hw, rowb, esize))
    return (int)cudaErrorInvalidValue;
  return (int)(bf16 ? launch_cluster(static_cast<const __nv_bfloat16*>(x),
                                     q, scale, n, c, hw, cp, pl, s)
                    : launch_cluster(static_cast<const float*>(x), q, scale,
                                     n, c, hw, cp, pl, s));
}

// How many clusters of k blocks of act_cluster (bf16 or float32 input),
// each with smem bytes of shared memory, the card holds at once, and how
// many such blocks an SM holds.
int quant_act_occupancy(int bf16, int k, int smem, int* clusters,
                        int* blocks_per_sm) {
  if (k < 1 || k > MAX_CLUSTER || smem < 0 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  return (int)(bf16 ? cluster_occupancy<__nv_bfloat16>(k, smem, clusters,
                                                       blocks_per_sm)
                    : cluster_occupancy<float>(k, smem, clusters,
                                               blocks_per_sm));
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
