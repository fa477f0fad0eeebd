// PAR appearance affinity from an edge-padded image, fp32 in, bf16 out.
//
// Replaces the TPU kernel excel_tpu/ops/par_pallas.py `_affinity_kernel`
// (:931, called by par_affinity). For each pixel (y, x) of image b, with the
// K neighbours n_k = img[:, y + P + dy_k, x + P + dx_k] of the centre
// x0 = img[:, y + P, x + P] in each of the 3 channels:
//
//   s1, s2 = sum_k n_k, sum_k n_k^2   (in chunks of 8 offsets, as the TPU)
//   var    = max(s2/K - (s1/K)^2, 0) * K/(K-1)
//   inv    = 1 / ((sqrt(var) + 1e-8) * w1)
//   l_k    = -(sum_c ((n_k - x0) * inv)^2) / 3
//   aff_k  = exp(l_k - max_k l) * (1 / sum_k exp(l_k - max_k l)) + wpos[k]
//
// with wpos[k] = w2 * pos_w[k] (fp32, from the caller), rounded once to
// bf16. Products and sums are rounded one by one in the TPU kernel's
// order (no FMA contraction); the exponential is CUDA's expf. The division
// by 3 is the correctly rounded quotient: RN(s * RN(1/3)) with one FMA
// correction where all K sums of a pixel are 0 or in [2^-100, inf) (for
// every float there this equals the IEEE division:
// tests/test_torch_par_fast.py checks each mantissa), else `third_exact`
// (out of line); so every value is the one the previous design computed
// with __fdiv_rn, bit for bit.
//
// What bounds it: the arithmetic. At the fast path's shapes (B=16, K=48,
// 384x512) the 302 MB of bf16 output and the 54 MB padded image take 0.106
// ms at 3.35 TB/s; a pixel's exact arithmetic (the moments, 48 logits, 48
// expf, IEEE divisions and square roots) executes about 1,650 fp32
// instructions on the FMA pipe, which take longer on 132 SMs
// (tools/par_ab.py --check counts them from the SASS; PERF.md has the
// bound). The previous design (a thread a pixel, a block a row, every
// neighbour read twice through L1/L2 at an offset loaded from global memory
// and multiplied out) took about 6x the bytes' time.
//
// Design:
// - Tiles of TH x 64 output pixels, a block of 8 warps each; lane l of a
//   warp owns columns l and l + 32 of its rows (TH = 32 at the paths' pad
//   24; 16 or 8 where the slab would not fit; `tiling`).
// - The tile's haloed slab, (TH + 2P) x (64 + 2P) in each of the 3
//   channels, is staged once in shared memory by 16-byte cp.async copies
//   where the image's rows allow (Wp a multiple of 4, a 16-byte aligned
//   image: the paths'), element by element elsewhere. Channel planes lie a
//   fixed kPlane floats apart (a template parameter: 9,216 floats, two
//   blocks an SM, for pads up to 32; 19,328 beyond), so a neighbour's three
//   channels are three loads at immediate offsets from one address, and the
//   32 lanes of a warp read 32 consecutive words, conflict-free.
// - The offsets come as kernel parameters (a __grid_constant__ table of the
//   byte displacement of each neighbour from a lane's base, worked out on
//   the host, and the position terms): one add of a constant-bank operand
//   a neighbour; the second pixel is 128 bytes on.
// - The moments of both pixels are summed together; then each pixel's K
//   logits in registers (K a template parameter), their softmax and its K
//   bf16 stores, one pixel after the other (one copy of that code: the
//   unrolled loops are long). A warp's store writes 64 contiguous bytes of
//   a plane row, two whole sectors; pairs of columns (128 bytes a warp)
//   would keep the first pixel's K results in registers while the second
//   is computed, which spilled (PERF.md).
// - Two resident blocks an SM (110.6 KB of slab each). They run in step,
//   so neither hides the other's copies (about a tenth of the eval launch);
//   a persistent block with a double-buffered slab, which would, measured
//   slower (PERF.md).
//
// A second entry point, excel_par_affinity_direct_bf16, takes the shapes
// the slab does not: a pad above 52 (no slab of 8 rows x 64 columns fits
// shared memory) or more than 64 offsets (the logits no longer fit the
// registers). A thread a pixel reads its neighbours from the image through
// L1/L2 (a warp's 32 lanes, 32 consecutive pixels of a row), twice: the
// moments, then the logits into a local array. The arithmetic is the slab
// kernel's, operation for operation (the division by 3 as __fdiv_rn, whose
// quotient third_fast and third_exact equal), so the two give the same bits
// where both run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 64;              // tile columns: 32 lanes x 2
constexpr int kChunk = 8;
constexpr int kMaxK = 64;
constexpr int kCh = 3;
// floats of a slab's channel plane: two blocks an SM (pads up to 32 at 8+
// rows), or one block of at most 227 KiB (pads up to 52); keep in step
// with ops/par_kernels.affinity_tiling
constexpr int kPlaneSmall = 9216;
constexpr int kPlaneLarge = 19328;
constexpr float kThird = 0x1.555556p-2f;  // RN(1/3)

struct Table {
  int d[kMaxK];      // neighbour k: byte offset from a lane's base
  float wpos[kMaxK];
  int centre;
};

struct Geo {
  int h, w, Hp, Wp, P;
  int th;        // tile rows
  int sh, sw;    // slab rows, and words a slab row (64 + 2P up to 4s)
  bool vec;      // 16-byte copies (Wp a multiple of 4, img aligned)
};

__device__ inline unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ inline void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ inline void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

// RN(s / 3), as __fdiv_rn(s, 3.f), without the library's slow-path call.
// third_fast, for s = 0 and s in [2^-100, inf): RN(s * RN(1/3)) and one FMA
// correction (the IEEE quotient for every float there). third_exact, for
// every s: for s < 3 * 2^-126, whose quotient is subnormal or 0,
// s = m 2^-149 with an integer m < 3 * 2^23, and RN(m / 3) = (m + 1) / 3 (a
// third is never a tie), the bits of the result; up to 2^-100 third_fast
// at s * 2^64, scaled back exactly; inf and NaN: s * RN(1/3).
__device__ __forceinline__ bool third_fits(float s) {
  return __float_as_uint(s) - 0x0D800000u < 0x7F800000u - 0x0D800000u;
}

__device__ __forceinline__ float third_fast(float s) {
  const float q = __fmul_rn(s, kThird);
  return __fmaf_rn(__fmaf_rn(-q, 3.f, s), kThird, q);
}

__device__ __forceinline__ float third_exact(float s) {
  const unsigned bits = __float_as_uint(s);
  if (third_fits(s)) return third_fast(s);
  if (bits < 0x01400000u) {
    const unsigned m =
        bits < 0x00800000u
            ? bits
            : ((bits & 0x007FFFFFu) | 0x00800000u) << ((bits >> 23) - 1);
    return __uint_as_float((m + 1) / 3);
  }
  if (bits < 0x0D800000u)
    return __fmul_rn(third_fast(__fmul_rn(s, 0x1p64f)), 0x1p-64f);
  return __fmul_rn(s, kThird);
}

// 1 / ((sqrt(var) + 1e-8) * w1) of each channel from the pixel's moments
template <int K>
__device__ __forceinline__ void inverse_scale(const float (&s1)[kCh],
                                              const float (&s2)[kCh],
                                              float w1, float (&inv)[kCh]) {
  const float kf = (float)K;
  const float kfac = (float)((double)K / (K - 1.0));
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const float mean = __fdiv_rn(s1[c], kf);
    const float var = __fmul_rn(
        fmaxf(__fsub_rn(__fdiv_rn(s2[c], kf), __fmul_rn(mean, mean)), 0.f),
        kfac);
    inv[c] = __fdiv_rn(1.f, __fmul_rn(__fadd_rn(__fsqrt_rn(var), 1e-8f), w1));
  }
}

// the neighbour at byte offset d from a pixel's base in the slab; channel c
// at n[c * kPlane]
__device__ __forceinline__ const float* at(const float* base, int d) {
  return (const float*)((const char*)base + d);
}

// one pixel's K affinities before their rounding to bf16: the logits, the
// softmax over the offsets, the position term. Returns false, with v
// undefined, where a sum lies in (0, 2^-100) or is infinite, the sums whose
// division by 3 third_fast may get wrong: `affinities_rare` then computes
// them. An infinite sum makes third_fast's quotient, and so the sum of the
// exponentials, NaN; so does a NaN sum, which the rare path would turn
// into the same NaN affinities.
template <int K, int kPlane>
__device__ __forceinline__ bool affinities(const float* base, const Table& t,
                                           const float (&inv)[kCh],
                                           float (&v)[K]) {
  const float* x0 = at(base, t.centre);
  const float ctr[kCh] = {x0[0], x0[kPlane], x0[2 * kPlane]};
  // s_k = sum_c d_c^2 (>= 0), their least (NaN aside), and the least of
  // their bits - 1 (a 0 sum is the greatest of these)
  float lo = INFINITY;
  unsigned low = ~0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float* n = at(base, t.d[k]);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const float d = __fmul_rn(__fsub_rn(n[c * kPlane], ctr[c]), inv[c]);
      const float dd = __fmul_rn(d, d);
      s = c == 0 ? dd : __fadd_rn(s, dd);
    }
    v[k] = s;
    lo = fminf(lo, s);
    low = min(low, __float_as_uint(s) - 1u);
  }
  if (low < 0x0D800000u - 1u) return false;
  // l_k = -s_k / 3; the greatest logit is -(least s) / 3, division being
  // monotone
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = -third_fast(v[k]);
  const float mx = -third_fast(lo);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = expf(__fsub_rn(v[k], mx));
    sum = k == 0 ? v[k] : __fadd_rn(sum, v[k]);
  }
  if (sum != sum) return false;
  const float inv_s = __fdiv_rn(1.f, sum);
#pragma unroll
  for (int k = 0; k < K; ++k)
    v[k] = __fadd_rn(__fmul_rn(v[k], inv_s), t.wpos[k]);
  return true;
}

// the same arithmetic for a pixel with a sum in (0, 2^-100), an infinite
// or a NaN one: a rolled loop over a local array, out of line, writing the
// K bf16 affinities at o, plane elements apart
template <int K, int kPlane>
__device__ __noinline__ void affinities_rare(const float* base,
                                             const Table& t, float inv0,
                                             float inv1, float inv2, bf16* o,
                                             size_t plane) {
  const float inv[kCh] = {inv0, inv1, inv2};
  const float* x0 = at(base, t.centre);
  const float ctr[kCh] = {x0[0], x0[kPlane], x0[2 * kPlane]};
  float l[K];
  float mx = -INFINITY;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const float* n = at(base, t.d[k]);
    float s = 0.f;
    for (int c = 0; c < kCh; ++c) {
      const float d = __fmul_rn(__fsub_rn(n[c * kPlane], ctr[c]), inv[c]);
      const float dd = __fmul_rn(d, d);
      s = c == 0 ? dd : __fadd_rn(s, dd);
    }
    l[k] = -third_exact(s);
    mx = fmaxf(mx, l[k]);
  }
  float sum = 0.f;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    l[k] = expf(__fsub_rn(l[k], mx));
    sum = k == 0 ? l[k] : __fadd_rn(sum, l[k]);
  }
  const float inv_s = __fdiv_rn(1.f, sum);
#pragma unroll 1
  for (int k = 0; k < K; ++k)
    o[k * plane] =
        __float2bfloat16_rn(__fadd_rn(__fmul_rn(l[k], inv_s), t.wpos[k]));
}

template <int K, int kPlane>
__global__ void __launch_bounds__(kThreads, 2)
    affinity_kernel(const float* __restrict__ img, bf16* __restrict__ out,
                    const __grid_constant__ Table t, const Geo g, float w1) {
  extern __shared__ float4 smem4[];
  float* slab = (float*)smem4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * g.th, b = blockIdx.z;

  // stage padded rows [y0, y0 + sh) x columns [x0, x0 + 64 + 2P), clipped
  // to the image: channel c, row r, column j at slab[c * kPlane + r * sw + j]
  const int n = min(kTW + 2 * g.P, g.Wp - x0);
  for (int c = 0; c < kCh; ++c)
    for (int r = warp; r < g.sh && y0 + r < g.Hp; r += kWarps) {
      const float* src =
          img + ((size_t)(b * kCh + c) * g.Hp + y0 + r) * g.Wp + x0;
      float* dst = slab + c * kPlane + r * g.sw;
      int j = 0;
      if (g.vec) {
        for (j = 4 * lane; j + 4 <= n; j += 4 * 32) cp16(dst + j, src + j);
        j = n / 4 * 4;
      }
      for (j += lane; j < n; j += 32) cp4(dst + j, src + j);
    }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int xa = x0 + lane;
  const size_t plane = (size_t)g.h * g.w;
#pragma unroll 1
  for (int r = warp; r < g.th && y0 + r < g.h; r += kWarps) {
    if (xa >= g.w) break;
    const float* base = slab + r * g.sw + lane;

    // moments of the lane's two pixels, chunked as the TPU kernel sums them
    float s1[2][kCh], s2[2][kCh];
#pragma unroll
    for (int c0 = 0; c0 < K; c0 += kChunk) {
      float p1[2][kCh], p2[2][kCh];
#pragma unroll
      for (int k = c0; k < c0 + kChunk; ++k) {
        const float* nb = at(base, t.d[k]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            const float x = nb[c * kPlane + 32 * i];
            const float sq = __fmul_rn(x, x);
            p1[i][c] = k == c0 ? x : __fadd_rn(p1[i][c], x);
            p2[i][c] = k == c0 ? sq : __fadd_rn(p2[i][c], sq);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          s1[i][c] = c0 == 0 ? p1[i][c] : __fadd_rn(s1[i][c], p1[i][c]);
          s2[i][c] = c0 == 0 ? p2[i][c] : __fadd_rn(s2[i][c], p2[i][c]);
        }
    }
    float inv[2][kCh];
    inverse_scale<K>(s1[0], s2[0], w1, inv[0]);
    inverse_scale<K>(s1[1], s2[1], w1, inv[1]);

    // each pixel's affinities, then its K stores
#pragma unroll 1
    for (int i = 0; i < 2 && xa + 32 * i < g.w; ++i) {
      const float sel[kCh] = {i ? inv[1][0] : inv[0][0],
                              i ? inv[1][1] : inv[0][1],
                              i ? inv[1][2] : inv[0][2]};
      float v[K];
      bf16* o = out + ((size_t)b * K * g.h + y0 + r) * g.w + xa + 32 * i;
      if (!affinities<K, kPlane>(base + 32 * i, t, sel, v)) {
        affinities_rare<K, kPlane>(base + 32 * i, t, sel[0], sel[1], sel[2],
                                   o, plane);
        continue;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) o[k * plane] = __float2bfloat16_rn(v[k]);
    }
  }
}

int slab_words(int th, int P) {
  return (th + 2 * P) * ((kTW + 2 * P + 3) / 4 * 4);
}

// tile rows and channel plane at pad P: the most rows of 32, 16, 8 whose
// slab fits the small plane, else the large one; rows 0 where none fits
void tiling(int P, int* th, int* plane) {
  const int rows[] = {32, 16, 8};
  for (int pl : {kPlaneSmall, kPlaneLarge})
    for (int r : rows)
      if (slab_words(r, P) <= pl) {
        *th = r, *plane = pl;
        return;
      }
  *th = *plane = 0;
}

// copy n bytes at src, host or device memory, to the host
int to_host(void* dst, const void* src, size_t n, cudaStream_t s) {
  cudaPointerAttributes at;
  cudaError_t err = cudaPointerGetAttributes(&at, src);
  if (err != cudaSuccess) return (int)err;
  if (at.type == cudaMemoryTypeDevice) {
    err = cudaMemcpyAsync(dst, src, n, cudaMemcpyDeviceToHost, s);
    if (err == cudaSuccess) err = cudaStreamSynchronize(s);
    return (int)err;
  }
  memcpy(dst, src, n);
  return 0;
}

template <int K, int kPlane>
int launch(const float* img, bf16* out, const Table& t, const Geo& g, int B,
           float w1, cudaStream_t s) {
  constexpr int smem = kCh * kPlane * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      affinity_kernel<K, kPlane>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.w + kTW - 1) / kTW, (g.h + g.th - 1) / g.th, B);
  affinity_kernel<K, kPlane><<<grid, kThreads, smem, s>>>(img, out, t, g, w1);
  return (int)cudaGetLastError();
}

template <int K>
int launch(const float* img, bf16* out, const Table& t, const Geo& g, int B,
           float w1, cudaStream_t s, int plane) {
  return plane == kPlaneSmall
             ? launch<K, kPlaneSmall>(img, out, t, g, B, w1, s)
             : launch<K, kPlaneLarge>(img, out, t, g, B, w1, s);
}

// ---------------------------------------------------------------------------
// the direct kernel: any pad, K up to kMaxKDirect
// ---------------------------------------------------------------------------

constexpr int kMaxKDirect = 128;
constexpr int kDirectThreads = 128;

struct DirectTable {
  int d[kMaxKDirect];  // neighbour k: element offset from the centre
  float wpos[kMaxKDirect];
};

__global__ void __launch_bounds__(kDirectThreads)
    affinity_direct_kernel(const float* __restrict__ img,
                           bf16* __restrict__ out,
                           const __grid_constant__ DirectTable t, int K,
                           int h, int w, int Hp, int Wp, int P, float w1) {
  const int x = blockIdx.x * kDirectThreads + threadIdx.x;
  const int y = blockIdx.y, b = blockIdx.z;
  if (x >= w) return;
  const size_t plane = (size_t)Hp * Wp;
  const float* ctr = img + (size_t)b * kCh * plane + (size_t)(y + P) * Wp +
                     x + P;

  // moments, chunked as the TPU kernel sums them
  float s1[kCh], s2[kCh];
  for (int c0 = 0; c0 < K; c0 += kChunk) {
    float p1[kCh], p2[kCh];
    for (int k = c0; k < c0 + kChunk; ++k)
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const float v = __ldg(ctr + c * plane + t.d[k]);
        const float sq = __fmul_rn(v, v);
        p1[c] = k == c0 ? v : __fadd_rn(p1[c], v);
        p2[c] = k == c0 ? sq : __fadd_rn(p2[c], sq);
      }
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      s1[c] = c0 == 0 ? p1[c] : __fadd_rn(s1[c], p1[c]);
      s2[c] = c0 == 0 ? p2[c] : __fadd_rn(s2[c], p2[c]);
    }
  }
  const float kf = (float)K;
  const float kfac = (float)((double)K / (K - 1.0));
  float inv[kCh], x0[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const float mean = __fdiv_rn(s1[c], kf);
    const float var = __fmul_rn(
        fmaxf(__fsub_rn(__fdiv_rn(s2[c], kf), __fmul_rn(mean, mean)), 0.f),
        kfac);
    inv[c] = __fdiv_rn(1.f, __fmul_rn(__fadd_rn(__fsqrt_rn(var), 1e-8f), w1));
    x0[c] = __ldg(ctr + c * plane);
  }

  // the logits, their softmax over the offsets, the position term
  float l[kMaxKDirect];
  float mx = -INFINITY;
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const float d =
          __fmul_rn(__fsub_rn(__ldg(ctr + c * plane + t.d[k]), x0[c]), inv[c]);
      const float dd = __fmul_rn(d, d);
      s = c == 0 ? dd : __fadd_rn(s, dd);
    }
    l[k] = -__fdiv_rn(s, 3.f);
    mx = fmaxf(mx, l[k]);
  }
  float sum = 0.f;
  for (int k = 0; k < K; ++k) {
    l[k] = expf(__fsub_rn(l[k], mx));
    sum = k == 0 ? l[k] : __fadd_rn(sum, l[k]);
  }
  const float inv_s = __fdiv_rn(1.f, sum);
  bf16* o = out + ((size_t)b * K * h + y) * w + x;
  const size_t oplane = (size_t)h * w;
  for (int k = 0; k < K; ++k)
    o[k * oplane] =
        __float2bfloat16_rn(__fadd_rn(__fmul_rn(l[k], inv_s), t.wpos[k]));
}

}  // namespace

// img: [B, 3, Hp, Wp] fp32 edge-padded on the device (pad P >= every |dy|,
// |dx|, Hp >= h + 2P, Wp >= w + 2P, any alignment); offsets: [K, 2] int32
// (dy, dx), K a multiple of 8 up to 64; wpos: [K] fp32; offsets and wpos in
// host memory (the wrapper's) or on the device (then read with a copy that
// waits for the stream); out: [B, K, h, w] bf16 on the device. Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue for a K or a pad the
// kernel does not take: the slab must fit shared memory, P <= 52).
extern "C" int excel_par_affinity_bf16(const float* img, const int* offsets,
                                       const float* wpos, bf16* out, int B,
                                       int h, int w, int Hp, int Wp, int K,
                                       int P, float w1, void* stream) {
  int th = 0, plane = 0;
  if (P >= 0) tiling(P, &th, &plane);
  if (B < 1 || h < 1 || w < 1 || K < kChunk || K > kMaxK || K % kChunk ||
      th == 0 || Hp < h + 2 * P || Wp < w + 2 * P || B > 65535 ||
      (h + th - 1) / th > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int offs[2 * kMaxK];
  Table t{};
  int err = to_host(offs, offsets, 2 * K * sizeof(int), s);
  if (err == 0) err = to_host(t.wpos, wpos, K * sizeof(float), s);
  if (err != 0) return err;
  Geo g{h,      w,  Hp, Wp, P, th, th + 2 * P, (kTW + 2 * P + 3) / 4 * 4,
        Wp % 4 == 0 && ((uintptr_t)img & 15) == 0};
  // byte offset of the neighbour at (dy, dx) from a lane's base, word
  // r * sw + l: slab row P + dy, column l + P + dx
  for (int k = 0; k < K; ++k) {
    const int dy = offs[2 * k], dx = offs[2 * k + 1];
    if (dy < -P || dy > P || dx < -P || dx > P)
      return (int)cudaErrorInvalidValue;
    t.d[k] = ((P + dy) * g.sw + P + dx) * (int)sizeof(float);
  }
  t.centre = (P * g.sw + P) * (int)sizeof(float);
  switch (K) {
#define EXCEL_AFFINITY_K(KK) \
  case KK:                   \
    return launch<KK>(img, out, t, g, B, w1, s, plane);
    EXCEL_AFFINITY_K(8)
    EXCEL_AFFINITY_K(16)
    EXCEL_AFFINITY_K(24)
    EXCEL_AFFINITY_K(32)
    EXCEL_AFFINITY_K(40)
    EXCEL_AFFINITY_K(48)
    EXCEL_AFFINITY_K(56)
    EXCEL_AFFINITY_K(64)
#undef EXCEL_AFFINITY_K
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same function by the direct kernel, for any pad P >= every |dy|, |dx|
// and K a multiple of 8 up to 128; the same arguments. Returns a
// cudaError_t (cudaErrorInvalidValue for a shape it does not take).
extern "C" int excel_par_affinity_direct_bf16(const float* img,
                                              const int* offsets,
                                              const float* wpos, bf16* out,
                                              int B, int h, int w, int Hp,
                                              int Wp, int K, int P, float w1,
                                              void* stream) {
  if (B < 1 || h < 1 || w < 1 || K < kChunk || K > kMaxKDirect ||
      K % kChunk || P < 0 || Hp < h + 2 * P || Wp < w + 2 * P || B > 65535 ||
      h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int offs[2 * kMaxKDirect];
  DirectTable t{};
  int err = to_host(offs, offsets, 2 * K * sizeof(int), s);
  if (err == 0) err = to_host(t.wpos, wpos, K * sizeof(float), s);
  if (err != 0) return err;
  for (int k = 0; k < K; ++k) {
    const int dy = offs[2 * k], dx = offs[2 * k + 1];
    if (dy < -P || dy > P || dx < -P || dx > P)
      return (int)cudaErrorInvalidValue;
    t.d[k] = dy * Wp + dx;
  }
  dim3 grid((w + kDirectThreads - 1) / kDirectThreads, h, B);
  affinity_direct_kernel<<<grid, kDirectThreads, 0, s>>>(img, out, t, K, h,
                                                          w, Hp, Wp, P, w1);
  return (int)cudaGetLastError();
}
