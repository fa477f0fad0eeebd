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
// order (no FMA contraction); the exponential is CUDA's expf.
//
// What bounds it: device memory. At the fast path's shapes (B=16, K=48,
// 384x512) the output is 302 MB of bf16 against 54 MB of padded image, and
// each pixel does about 1,500 flops. Design: one thread per output pixel,
// threads along x, so each of the K output planes is written as coalesced
// row segments; the K logits stay in registers (K is a template parameter,
// 8 per dilation); the neighbour reads of the three passes (moments, logits,
// softmax needs none) are served from L1/L2, the image being read from
// device memory about once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;

template <int K>
__global__ void __launch_bounds__(kThreads)
    affinity_kernel(const float* __restrict__ img,
                    const int* __restrict__ offsets,
                    const float* __restrict__ wpos,
                    __nv_bfloat16* __restrict__ out, int h, int w, int Hp,
                    int Wp, int P, float w1) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= w) return;
  const size_t plane = (size_t)Hp * Wp;
  // the centre pixel in each channel; neighbours at signed offsets from it
  const float* im = img + (size_t)b * 3 * plane + (size_t)(y + P) * Wp + x + P;
  const float* ch[3] = {im, im + plane, im + 2 * plane};

  // pass A: neighbour moments, chunked as the TPU kernel sums them
  float s1[3], s2[3];
#pragma unroll
  for (int c0 = 0; c0 < K; c0 += kChunk) {
    float p1[3], p2[3];
#pragma unroll
    for (int k = c0; k < c0 + kChunk; ++k) {
      const int o = __ldg(offsets + 2 * k) * Wp + __ldg(offsets + 2 * k + 1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float n = ch[c][o];
        const float sq = __fmul_rn(n, n);
        p1[c] = k == c0 ? n : __fadd_rn(p1[c], n);
        p2[c] = k == c0 ? sq : __fadd_rn(p2[c], sq);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s1[c] = c0 == 0 ? p1[c] : __fadd_rn(s1[c], p1[c]);
      s2[c] = c0 == 0 ? p2[c] : __fadd_rn(s2[c], p2[c]);
    }
  }
  const float kf = (float)K;
  const float kfac = (float)((double)K / (K - 1.0));
  float inv[3], ctr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mean = __fdiv_rn(s1[c], kf);
    const float var = __fmul_rn(
        fmaxf(__fsub_rn(__fdiv_rn(s2[c], kf), __fmul_rn(mean, mean)), 0.f),
        kfac);
    inv[c] = __fdiv_rn(1.f, __fmul_rn(__fadd_rn(__fsqrt_rn(var), 1e-8f), w1));
    ctr[c] = ch[c][0];
  }

  // pass B: per-offset logits (channel mean of -d^2), kept in registers
  float l[K];
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int o = __ldg(offsets + 2 * k) * Wp + __ldg(offsets + 2 * k + 1);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = __fmul_rn(__fsub_rn(ch[c][o], ctr[c]), inv[c]);
      const float dd = __fmul_rn(d, d);
      s = c == 0 ? dd : __fadd_rn(s, dd);
    }
    l[k] = -__fdiv_rn(s, 3.f);
    mx = fmaxf(mx, l[k]);
  }

  // softmax over the offsets, then the position term; one rounding to bf16
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    l[k] = expf(__fsub_rn(l[k], mx));
    sum = k == 0 ? l[k] : __fadd_rn(sum, l[k]);
  }
  const float inv_s = __fdiv_rn(1.f, sum);
  __nv_bfloat16* o = out + ((size_t)b * K * h + y) * w + x;
#pragma unroll
  for (int k = 0; k < K; ++k)
    o[(size_t)k * h * w] = __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(l[k], inv_s), __ldg(wpos + k)));
}

}  // namespace

// img: [B, 3, Hp, Wp] fp32 edge-padded (pad P >= every |dy|, |dx|);
// offsets: [K, 2] int32 (dy, dx), K a multiple of 8 up to 64; wpos: [K]
// fp32; out: [B, K, h, w] bf16; all on the device. Returns a cudaError_t
// (0 on success).
extern "C" int excel_par_affinity_bf16(const float* img, const int* offsets,
                                       const float* wpos, __nv_bfloat16* out,
                                       int B, int h, int w, int Hp, int Wp,
                                       int K, int P, float w1, void* stream) {
  dim3 grid((w + kThreads - 1) / kThreads, h, B);
  cudaStream_t s = (cudaStream_t)stream;
#define EXCEL_AFFINITY_K(KK)                                           \
  case KK:                                                             \
    affinity_kernel<KK><<<grid, kThreads, 0, s>>>(img, offsets, wpos,  \
                                                  out, h, w, Hp, Wp, P, \
                                                  w1);                 \
    break;
  switch (K) {
    EXCEL_AFFINITY_K(8)
    EXCEL_AFFINITY_K(16)
    EXCEL_AFFINITY_K(24)
    EXCEL_AFFINITY_K(32)
    EXCEL_AFFINITY_K(40)
    EXCEL_AFFINITY_K(48)
    EXCEL_AFFINITY_K(56)
    EXCEL_AFFINITY_K(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef EXCEL_AFFINITY_K
  return (int)cudaGetLastError();
}
