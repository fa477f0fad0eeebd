// One diffusion step over unpadded masks, fp32 or bf16: PAR's step, and the
// message pass of the convolutional mean-field CRF (ops/crf_tpu.py).
//
// Replaces the TPU kernel excel_tpu/ops/par_pallas.py `_diffuse_kernel`
// (:31, called by par_diffuse) on the per-step route of
// excel_tpu/ops/par.py:340-350 and in excel_tpu/ops/crf_tpu.py:266-283:
//
//   out[b, c, y, x] = sum_k aff[b, k, y, x] * m[b, c, cy(y + dy_k), cx(x + dx_k)]
//
// with cy, cx clamping to the canvas, which equals reading an edge-padded
// copy (the TPU kernel's input). The TPU kernel's 128-lane padding and slack
// rows served only its DMA alignment, so no padded copy is made here.
//
// What bounds it: device memory. At the eval shapes (B=16, C=4, K=48,
// 384x512) the affinities are 604 MB per step, far beyond the 50 MB L2, and
// every step streams them once; the masks add 101 MB in and out. Design: one
// thread per pixel reads each of its K affinities once and applies it to up
// to kGroup channels held in registers, so aff is read once per step when
// C <= kGroup (more channels re-read it once per group). Neighbour reads of
// the masks are coalesced along x and served from L1/L2 (K * C of them per
// pixel, the kernel's real limit at these shapes: PERF.md). Products and
// sums are rounded separately (no FMA contraction) in offset order, which
// is the plain version's arithmetic, so the two agree bit for bit.
//
// The bf16 entry point (masks, affinities and output in bf16: the fast
// preset's CRF messages) keeps the TPU kernel's rounding points, not its
// tiling: each product aff_k * m is rounded to bf16 (a product of two bf16
// values is exact in fp32, so one __float2bfloat16_rn of it is that
// rounding), the rounded products of a chunk of 8 offsets are summed in
// fp32 in offset order, each chunk's sum is rounded to bf16, and the running
// output is a bf16 value: out = bf16(part_0), then
// out = bf16(float(out) + float(bf16(part_c))) for each later chunk. Every
// product and sum is written as a single-rounding intrinsic so that nvcc
// contracts none into an FMA. At the CRF's shapes (B=4, C=21, K=72,
// 384x512, bf16) the affinities are 113 MB and are re-read once per group
// of kGroup channels (three times at C=21, eleven at C=81): PERF.md has
// the time beside the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;    // channels held in registers per pass
constexpr int kThreads = 256;
constexpr int kChunk = 8;    // offsets per fp32 partial sum (bf16 entry point)

__global__ void __launch_bounds__(kThreads)
    par_diffuse_kernel(const float* __restrict__ m,
                       const float* __restrict__ aff,
                       const int* __restrict__ offsets,
                       float* __restrict__ out, int C, int H, int W, int K) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;
  const size_t hw = (size_t)H * W;
  const size_t pix = (size_t)y * W + x;
  const float* a = aff + (size_t)b * K * hw + pix;
  for (int c0 = 0; c0 < C; c0 += kGroup) {
    const float* mb = m + ((size_t)b * C + c0) * hw;
    float acc[kGroup];
#pragma unroll
    for (int c = 0; c < kGroup; ++c) acc[c] = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      const float w = a[(size_t)kk * hw];
      const int yy = min(max(y + __ldg(offsets + 2 * kk), 0), H - 1);
      const int xx = min(max(x + __ldg(offsets + 2 * kk + 1), 0), W - 1);
      const size_t p = (size_t)yy * W + xx;
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        if (c0 + c < C)
          acc[c] = __fadd_rn(acc[c], __fmul_rn(w, mb[(size_t)c * hw + p]));
    }
#pragma unroll
    for (int c = 0; c < kGroup; ++c)
      if (c0 + c < C) out[((size_t)b * C + c0 + c) * hw + pix] = acc[c];
  }
}

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(kThreads)
    par_diffuse_bf16_kernel(const bf16* __restrict__ m,
                            const bf16* __restrict__ aff,
                            const int* __restrict__ offsets,
                            bf16* __restrict__ out, int C, int H, int W,
                            int K) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;
  const size_t hw = (size_t)H * W;
  const size_t pix = (size_t)y * W + x;
  const bf16* a = aff + (size_t)b * K * hw + pix;
  for (int c0 = 0; c0 < C; c0 += kGroup) {
    const bf16* mb = m + ((size_t)b * C + c0) * hw;
    float acc[kGroup];   // the running output: always a bf16 value
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      float part[kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) part[c] = 0.f;
      const int k1 = min(k0 + kChunk, K);
      for (int kk = k0; kk < k1; ++kk) {
        const float w = __bfloat162float(a[(size_t)kk * hw]);
        const int yy = min(max(y + __ldg(offsets + 2 * kk), 0), H - 1);
        const int xx = min(max(x + __ldg(offsets + 2 * kk + 1), 0), W - 1);
        const size_t p = (size_t)yy * W + xx;
#pragma unroll
        for (int c = 0; c < kGroup; ++c)
          if (c0 + c < C) {
            const float term = __bfloat162float(__float2bfloat16_rn(
                __fmul_rn(w, __bfloat162float(mb[(size_t)c * hw + p]))));
            part[c] = __fadd_rn(part[c], term);
          }
      }
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        const float r = __bfloat162float(__float2bfloat16_rn(part[c]));
        acc[c] = k0 == 0 ? r
                         : __bfloat162float(__float2bfloat16_rn(
                               __fadd_rn(acc[c], r)));
      }
    }
#pragma unroll
    for (int c = 0; c < kGroup; ++c)
      if (c0 + c < C)
        out[((size_t)b * C + c0 + c) * hw + pix] = __float2bfloat16_rn(acc[c]);
  }
}

}  // namespace

// m, out: [B, C, H, W]; aff: [B, K, H, W]; offsets: [K, 2] int32 (dy, dx),
// all on the device. Returns a cudaError_t (0 on success).
extern "C" int excel_par_diffuse_f32(const float* m, const float* aff,
                                     const int* offsets, float* out, int B,
                                     int C, int H, int W, int K,
                                     void* stream) {
  dim3 grid((W + kThreads - 1) / kThreads, H, B);
  par_diffuse_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      m, aff, offsets, out, C, H, W, K);
  return (int)cudaGetLastError();
}

// The same step with m, aff and out in bf16 (the rounding points above).
extern "C" int excel_par_diffuse_bf16(const void* m, const void* aff,
                                      const int* offsets, void* out, int B,
                                      int C, int H, int W, int K,
                                      void* stream) {
  dim3 grid((W + kThreads - 1) / kThreads, H, B);
  par_diffuse_bf16_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)m, (const bf16*)aff, offsets, (bf16*)out, C, H, W, K);
  return (int)cudaGetLastError();
}
