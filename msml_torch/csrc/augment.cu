// Block occlusion + Gaussian relight + normalize, NHWC (f32 or uint8) in,
// NCHW f32 out, for Hopper (sm_90a): one thread-block cluster per image.
//
// Replaces the Pallas kernel `_gauss_block_kernel` of
// msml_tpu/kernels/augment.py (launched by `pallas_augment_batch`). The
// design notes are in msml_torch/kernels/augment.py; the blocking (cluster
// size, band rows, copy and store widths, shared memory) comes from its
// `augment_geometry`.
//
// Plain C interface for ctypes: the entry point launches on the caller's
// stream, allocates nothing, and returns the cudaError_t of its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;      // 4 warps a block
constexpr int MIN_BLOCKS = 8;     // blocks of a uint8 relight launch that
                                  // fit an SM's shared memory: registers
                                  // must not hold it to fewer
constexpr int PARTS = 2;          // copy groups a band is staged in
constexpr int SCRATCH = 16;       // floats after the band: the warps'
                                  // maxima (slots), read by the cluster
constexpr int MAX_SMEM = 232448;  // an H100 block's opt-in shared memory

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// BYTES (4, 8 or 16) global -> shared without registers
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES));
}

// Bytes [from, to) of the band (multiples of VEC) from global to shared
// memory as one cp.async group, one copy of VEC bytes per thread and step,
// neighbouring threads on neighbouring copies; VEC == 1 goes through
// registers byte by byte.
template <int VEC>
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* src, int from,
                                      int to) {
  if constexpr (VEC == 1) {
    for (int i = from + threadIdx.x; i < to; i += THREADS) dst[i] = src[i];
  } else {
    for (int i = from + threadIdx.x * VEC; i < to; i += THREADS * VEC)
      cp_async<VEC>(dst + i, src + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// Wait until at most n (< PARTS) of the thread's copy groups are still in
// flight; VEC == 1 copies have no groups and return at once.
__device__ __forceinline__ void wait_staged(int n) {
  static_assert(PARTS == 2, "one wait_group per part");
  if (n == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// a / b rounded to nearest, as IEEE division gives it, from y = RN(1 / b):
// q = RN(a y), then one FMA correction (Markstein's theorem: the residual
// a - b q is exact, and RN(q + (a - b q) y) is the correctly rounded
// quotient for any normal a / b). Three instructions in place of a
// division's sequence and its range check.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
}

constexpr float INV255 = 0x1.010102p-8f;  // RN(1 / 255)

// The image's draws, in the plain version's order of f32 operations
// (kernels/augment.py::augment_batch_reference); the _rn intrinsics keep
// the compiler from contracting a product and a sum into one FMA.
struct Draws {
  float x0, x1, y0, y1;  // the square: x0 <= x < x1, y0 <= y < y1
  float cx, cy, scale;   // the light's centre and peak
};

__device__ __forceinline__ Draws image_draws(const float* d, int h, int w,
                                             int lo, int hi) {
  const float wf = static_cast<float>(w);
  Draws r;
  const float ratio = __fmul_rn(
      __fadd_rn(static_cast<float>(lo),
                floorf(__fmul_rn(d[0], static_cast<float>(hi - lo)))),
      0.01f);
  const float bw = floorf(__fmul_rn(sqrtf(ratio), wf));
  const float span = __fadd_rn(__fsub_rn(wf, bw), 1.0f);
  r.x0 = floorf(__fmul_rn(d[1], span));
  r.y0 = floorf(__fmul_rn(d[2], span));  // W for both, as the reference
  r.x1 = __fadd_rn(r.x0, bw);
  r.y1 = __fadd_rn(r.y0, bw);
  r.cx = __fmul_rn(d[3], wf);
  r.cy = __fmul_rn(d[4], static_cast<float>(h));
  r.scale = __fadd_rn(__fmul_rn(d[5], 0.7f), 0.7f);
  return r;
}

// Byte b of `word` as a float, exactly, without a conversion instruction
// (a quarter-rate I2F): the byte under the exponent of 2^23, minus 2^23.
__device__ __forceinline__ float byte_float(uint32_t word, int b) {
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u,
                                               0x7650u | b)),
                   8388608.0f);
}

// Whether pixel (xf, yf) (integers held in floats) is inside the square,
// and its light.
template <bool RELIGHT>
__device__ __forceinline__ void pixel(float xf, float yf, const Draws& d,
                                      bool has_block, bool& inside,
                                      float& light) {
  inside = has_block && xf >= d.x0 && xf < d.x1 && yf >= d.y0 && yf < d.y1;
  light = 1.0f;
  if constexpr (RELIGHT) {
    const float dx = __fsub_rn(xf, d.cx), dy = __fsub_rn(yf, d.cy);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    // -0.5 d2 / 16384 as d2 * -2^-15: both steps scale by powers of two,
    // so one product rounds the same real number the same way
    light = __fmul_rn(expf(__fmul_rn(d2, -0x1p-15f)), d.scale);
  }
}

// One element after the fill and the light; e is its index in the band.
template <bool RELIGHT>
__device__ __forceinline__ float element(float v, bool inside, float light,
                                         const float* noise, int e,
                                         int fill) {
  if (inside) v = fill == 2 ? noise[e] : (fill == 1 ? 1.0f : 0.0f);
  if constexpr (RELIGHT) v = __fmul_rn(v, light);
  return v;
}

template <bool U8>
__device__ __forceinline__ float staged(const unsigned char* band, int e) {
  if constexpr (U8)
    return div_rn(byte_float(band[e], 0), 255.0f, INV255);
  else
    return reinterpret_cast<const float*>(band)[e];
}

// v / denom (relight; inv = RN(1 / denom)), then (v - 0.5) / 0.5 as
// (v - 0.5) * 2, the same real number
template <bool RELIGHT>
__device__ __forceinline__ float finish(float v, float denom, float inv,
                                        bool use_norm) {
  if constexpr (RELIGHT) v = div_rn(v, denom, inv);
  if (use_norm) v = __fmul_rn(__fsub_rn(v, 0.5f), 2.0f);
  return v;
}

// out[e], out[e + 1], ... = o[0 .. 3], SV floats a store (SV divides 4)
template <int SV>
__device__ __forceinline__ void store4(float* out, const float* o) {
  if constexpr (SV == 4)
    *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
  else if constexpr (SV == 2) {
    reinterpret_cast<float2*>(out)[0] = make_float2(o[0], o[1]);
    reinterpret_cast<float2*>(out)[1] = make_float2(o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = o[j];
  }
}

// The 4 C staged NHWC values of the group of 4 pixels g as floats: C loads
// of 16 bytes (f32) or 4 bytes (uint8); the lanes of a warp, on
// consecutive groups, read 4 C elements apart (no bank conflict).
template <bool U8, int C>
__device__ __forceinline__ void load_group(const unsigned char* band, int g,
                                           float (&v)[4 * C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    if constexpr (U8) {
      const uint32_t word = reinterpret_cast<const uint32_t*>(band)[g * C + k];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v[4 * k + b] = div_rn(byte_float(word, b), 255.0f, INV255);
    } else {
      const float4 f = reinterpret_cast<const float4*>(band)[g * C + k];
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  }
}

// Pixels [p0, p1) of the band (p0 a multiple of 4): thread t takes the
// groups of 4 pixels g = p0 / 4 + t, + THREADS, ..., and calls
// group(g, inside[4], light[4]); then the last (p1 - p0) mod 4 pixels one
// per thread, single(lp, inside, light). (x, y) steps along in floats,
// with no integer-to-float conversion in the loop.
template <bool RELIGHT, typename Group, typename Single>
__device__ __forceinline__ void walk(int p0, int p1, int w, int row0,
                                     const Draws& d, bool has_block,
                                     Group&& group, Single&& single) {
  const int g1 = p0 / 4 + (p1 - p0) / 4;
  const int sx = 4 * THREADS % w, sy = 4 * THREADS / w;
  const float wf = static_cast<float>(w);
  int g = p0 / 4 + threadIdx.x;
  int x = 4 * g % w;  // (x, y) of the group's first pixel, also as floats
  float xf = static_cast<float>(x), yf = static_cast<float>(row0 + 4 * g / w);
  for (; g < g1; g += THREADS) {
    bool inside[4];
    float light[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float xj = xf + static_cast<float>(j), yj = yf;
      while (xj >= wf) {  // a group that runs into the next row(s)
        xj = __fsub_rn(xj, wf);
        yj = __fadd_rn(yj, 1.0f);
      }
      pixel<RELIGHT>(xj, yj, d, has_block, inside[j], light[j]);
    }
    group(g, inside, light);
    x += sx;
    xf = __fadd_rn(xf, static_cast<float>(sx));
    yf = __fadd_rn(yf, static_cast<float>(sy));
    if (x >= w) {
      x -= w;
      xf = __fsub_rn(xf, wf);
      yf = __fadd_rn(yf, 1.0f);
    }
  }
  const int lp = 4 * g1 + threadIdx.x;
  if (lp < p1) {
    bool inside;
    float light;
    pixel<RELIGHT>(static_cast<float>(lp % w),
                   static_cast<float>(row0 + lp / w), d, has_block, inside,
                   light);
    single(lp, inside, light);
  }
}

// Without relight, one pass: the finished values of pixels [p0, p1) go
// straight to the C NCHW runs of the band at out + ch * hw, transposed in
// registers, each channel's 4 pixels in stores of SV floats (lanes on
// consecutive groups: a warp writes 512 contiguous bytes a channel).
template <bool U8, int C, int SV>
__device__ __forceinline__ void direct(const unsigned char* band,
                                       const float* noise, float* out,
                                       int hw, int p0, int p1, int w,
                                       int row0, const Draws& d,
                                       bool has_block, int fill,
                                       bool use_norm) {
  walk<false>(
      p0, p1, w, row0, d, has_block,
      [&](int g, const bool (&inside)[4], const float (&light)[4]) {
        float v[4 * C];
        load_group<U8, C>(band, g, v);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          float o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            o[j] = finish<false>(
                element<false>(v[j * C + ch], inside[j], light[j], noise,
                               (4 * g + j) * C + ch, fill),
                1.0f, 1.0f, use_norm);
          store4<SV>(out + (size_t)ch * hw + 4 * g, o);
        }
      },
      [&](int lp, bool inside, float light) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          out[(size_t)ch * hw + lp] = finish<false>(
              element<false>(staged<U8>(band, lp * C + ch), inside, light,
                             noise, lp * C + ch, fill),
              1.0f, 1.0f, use_norm);
      });
}

// direct with the channel count and the store width as runtime values
template <bool U8>
__device__ __forceinline__ void direct_pass(int c, int store_vec,
                                            const unsigned char* band,
                                            const float* noise, float* out,
                                            int hw, int p0, int p1, int w,
                                            int row0, const Draws& d,
                                            bool has_block, int fill,
                                            bool use_norm) {
#define DIRECT(C, SV)                                                      \
  direct<U8, C, SV>(band, noise, out, hw, p0, p1, w, row0, d, has_block,  \
                    fill, use_norm)
  if (c == 3) {
    if (store_vec == 4) DIRECT(3, 4); else if (store_vec == 2) DIRECT(3, 2);
    else DIRECT(3, 1);
  } else {
    if (store_vec == 4) DIRECT(1, 4); else if (store_vec == 2) DIRECT(1, 2);
    else DIRECT(1, 1);
  }
#undef DIRECT
}

// With relight, the first pass over pixels [p0, p1): the relit values
// into the channel-major tile [C][plane] (the NHWC -> NCHW transpose, done
// once in shared memory) and their maximum into m. One 16-byte store per
// channel and group at tile[ch * plane + 4 g], lanes on consecutive 16
// bytes: no bank conflict.
template <bool U8, int C>
__device__ __forceinline__ void make_tile(const unsigned char* band,
                                          const float* noise, float* tile,
                                          int plane, int p0, int p1, int w,
                                          int row0, const Draws& d,
                                          bool has_block, int fill,
                                          float& m) {
  walk<true>(
      p0, p1, w, row0, d, has_block,
      [&](int g, const bool (&inside)[4], const float (&light)[4]) {
        float v[4 * C];
        load_group<U8, C>(band, g, v);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          float o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            o[j] = element<true>(v[j * C + ch], inside[j], light[j], noise,
                                 (4 * g + j) * C + ch, fill);
            m = fmaxf(m, o[j]);
          }
          *reinterpret_cast<float4*>(tile + ch * plane + 4 * g) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
      },
      [&](int lp, bool inside, float light) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const float e = element<true>(staged<U8>(band, lp * C + ch),
                                        inside, light, noise, lp * C + ch,
                                        fill);
          tile[ch * plane + lp] = e;
          m = fmaxf(m, e);
        }
      });
}

template <int N> struct Floats;
template <> struct Floats<4> { using type = float4; };
template <> struct Floats<2> { using type = float2; };
template <> struct Floats<1> { using type = float; };

// The relight's second pass: the band's C NCHW runs (channel ch at
// out + ch * hw, npix floats each) from the tile, divided by the image's
// maximum and normalized, SV floats per load and store; thread t takes
// vector t, t + THREADS, ... of the C runs laid end to end.
template <int SV>
__device__ __forceinline__ void tile_store(const float* tile, float* out,
                                           int plane, int npix, int c,
                                           int hw, float denom,
                                           bool use_norm) {
  using V = typename Floats<SV>::type;
  const float inv = __frcp_rn(denom);
  int ch = 0;
  for (int i = threadIdx.x * SV;; i += THREADS * SV) {
    while (i >= npix && ch < c) {  // on to the next channel's run
      i -= npix;
      ++ch;
    }
    if (ch == c) break;
    V v = *reinterpret_cast<const V*>(tile + ch * plane + i);
    float* f = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int e = 0; e < SV; ++e) f[e] = finish<true>(f[e], denom, inv, use_norm);
    *reinterpret_cast<V*>(out + (size_t)ch * hw + i) = v;
  }
}

// Block (b, k) of cluster b owns rows [k rows, min(h, (k + 1) rows)) of
// image b: it stages the band (one contiguous NHWC run) once and writes
// its C NCHW runs once. Without RELIGHT it writes them as it goes. With
// RELIGHT it makes the tile of relit values and their maximum, shares the
// maximum with the K - 1 other blocks of its cluster through distributed
// shared memory, then divides, normalizes and writes the tile.
template <bool U8, bool RELIGHT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
augment_cluster(const unsigned char* __restrict__ img,
                const float* __restrict__ draws,
                const float* __restrict__ noise, float* __restrict__ out,
                int h, int w, int c, int k_per_image, int rows, int vec,
                int store_vec, int lo, int hi, int fill, int has_block,
                int use_norm) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ESIZE = U8 ? 1 : 4;
  const int b = blockIdx.x / k_per_image;
  const int k = blockIdx.x - b * k_per_image;
  const int row0 = min(h, k * rows);
  const int npix = (min(h, row0 + rows) - row0) * w;  // 0: an empty band
  unsigned char* band = smem;  // then, with RELIGHT, the tile, then slots

  const size_t first = ((size_t)b * h + row0) * w * c;  // the band's element
  const unsigned char* src = img + first * ESIZE;
  // PARTS copy groups: each part of the band is worked on while the later
  // ones are in flight; parts of a multiple of 16 pixels keep whole copies
  // and whole groups of 4 pixels
  int cut[PARTS + 1];
#pragma unroll
  for (int i = 0; i <= PARTS; ++i) cut[i] = npix * i / PARTS / 16 * 16;
  cut[PARTS] = npix;
#pragma unroll
  for (int i = 0; i < PARTS; ++i) {
    const int from = cut[i] * c * ESIZE, to = cut[i + 1] * c * ESIZE;
    switch (vec) {
      case 16: stage<16>(band, src, from, to); break;
      case 8: stage<8>(band, src, from, to); break;
      case 4: stage<4>(band, src, from, to); break;
      default: stage<1>(band, src, from, to); break;
    }
  }
  const Draws d = image_draws(draws + (size_t)b * 6, h, w, lo, hi);
  const float* noise_band = fill == 2 && has_block ? noise + first : nullptr;
  float* out_band = out + (size_t)b * c * h * w + (size_t)row0 * w;
  const int hw = h * w;

  if constexpr (!RELIGHT) {
#pragma unroll
    for (int i = 0; i < PARTS; ++i) {
      wait_staged(PARTS - 1 - i);
      __syncthreads();
      direct_pass<U8>(c, store_vec, band, noise_band, out_band, hw, cut[i],
                      cut[i + 1], w, row0, d, has_block, fill, use_norm);
    }
  } else {
    float* tile =
        reinterpret_cast<float*>(band + round16(rows * w * c * ESIZE));
    const int plane = (rows * w + 3) / 4 * 4;
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < PARTS; ++i) {
      wait_staged(PARTS - 1 - i);
      __syncthreads();
      if (c == 3)
        make_tile<U8, 3>(band, noise_band, tile, plane, cut[i], cut[i + 1],
                         w, row0, d, has_block, fill, m);
      else
        make_tile<U8, 1>(band, noise_band, tile, plane, cut[i], cut[i + 1],
                         w, row0, d, has_block, fill, m);
    }
    // each warp's maximum into this block's slots [THREADS / 32]; after the
    // cluster barrier every warp reads the K blocks' slots itself
    constexpr int WARPS = THREADS / 32;
    float* slots = tile + c * plane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const int lane = threadIdx.x & 31;
    if (lane == 0) slots[threadIdx.x >> 5] = m;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every warp's maximum is in its block's slots
    float image_max = -INFINITY;
#pragma unroll
    for (int s = lane; s < 8 * WARPS; s += 32)  // K <= 8 blocks
      if (s < k_per_image * WARPS)
        image_max = fmaxf(image_max, *cluster.map_shared_rank(
                                         slots + s % WARPS, s / WARPS));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      image_max = fmaxf(image_max, __shfl_xor_sync(0xffffffffu, image_max, o));
    // done with the peers' slots; the matching wait comes before the exit,
    // so no block leaves while a peer may still read its slots
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    const float denom = fmaxf(image_max, 1e-6f);
    switch (store_vec) {
      case 4: tile_store<4>(tile, out_band, plane, npix, c, hw, denom,
                            use_norm); break;
      case 2: tile_store<2>(tile, out_band, plane, npix, c, hw, denom,
                            use_norm); break;
      default: tile_store<1>(tile, out_band, plane, npix, c, hw, denom,
                             use_norm); break;
    }
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

using Kernel = void (*)(const unsigned char*, const float*, const float*,
                        float*, int, int, int, int, int, int, int, int, int,
                        int, int, int);

Kernel pick(int u8, int relight) {
  return u8 ? (relight ? augment_cluster<true, true>
                       : augment_cluster<true, false>)
            : (relight ? augment_cluster<false, true>
                       : augment_cluster<false, false>);
}

}  // namespace

extern "C" {

// out (b, c, h, w) f32 = the augmentation of img (b, h, w, c), f32 or uint8
// (u8 != 0), with draws (b, 6) f32 and, for the gauss fill, noise shaped
// like img in f32 (else null). The blocking comes from augment_geometry:
// `cluster` blocks per image, `rows` rows a block, copies of `vec` bytes,
// stores of `store_vec` floats, `smem` bytes of dynamic shared memory.
// fill: 0 black, 1 white, 2 gauss.
int augment_batch(const void* img, const void* draws, const void* noise,
                  void* out, int b, int h, int w, int c, int u8, int cluster,
                  int rows, int vec, int store_vec, int smem, int lo, int hi,
                  int fill, int has_block, int relight, int use_norm,
                  void* stream) {
  const int esize = u8 ? 1 : 4;
  if ((c != 1 && c != 3) || cluster < 1 || cluster > 8 || rows < 1 ||
      (vec != 16 && vec != 8 && vec != 4 && vec != esize) ||
      (store_vec != 4 && store_vec != 2 && store_vec != 1) ||
      smem > MAX_SMEM ||
      smem < round16(rows * w * c * esize) +
                 (relight ? 4 * c * ((rows * w + 3) / 4 * 4) : 0) +
                 4 * SCRATCH ||
      reinterpret_cast<uintptr_t>(img) % vec != 0 ||
      reinterpret_cast<uintptr_t>(out) % (4 * store_vec) != 0 ||
      (fill == 2 && has_block && noise == nullptr))
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = pick(u8, relight);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  if (relight) {  // the band maxima are shared within the cluster
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const unsigned char*>(img),
      static_cast<const float*>(draws), static_cast<const float*>(noise),
      static_cast<float*>(out), h, w, c, cluster, rows, vec, store_vec, lo,
      hi, fill, has_block, use_norm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` relight blocks, and how many blocks
// without a cluster, of `smem` bytes can be resident at once on the card.
int augment_occupancy(int u8, int cluster, int smem, int* clusters,
                      int* blocks_per_sm) {
  const Kernel relit = pick(u8, 1), plain = pick(u8, 0);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      ((err = cudaFuncSetAttribute(
            relit, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
           cudaSuccess ||
       (err = cudaFuncSetAttribute(
            plain, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
           cudaSuccess))
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaOccupancyMaxActiveClusters(clusters, relit, &cfg)) !=
      cudaSuccess)
    return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, plain, THREADS, smem);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
