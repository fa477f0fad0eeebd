// Plain softmax attention with an optional head-mean of the weights, for
// fp32 and bf16 q/k/v (fp32 weights either way).
//
// Replaces the TPU kernels excel_tpu/models/attention_pallas.py
// `_plain_kernel` (:52, called by fused_plain_attention) and
// `_plain_kernel_rows_hb` (:157, the no-weights route for N <= 512).
//
//   ctx[b, h]   = softmax(q[b, h] k[b, h]^T * D^-1/2) v[b, h]
//   weights[b]  = sum_h softmax(...)[b, h] / H            (mode out)
//   weights[b] += sum_h softmax(...)[b, h] / H, in place  (mode acc)
//
// What bounds it: fp32 arithmetic. At the encoder's shapes (B=16, H=12,
// N=401, D=64) one launch does 2 * 2*N^2*D*H*B = 7.9 GFLOP against 79 MB of
// q/k/v/ctx (40 MB in bf16). The bf16 entry point stages q/k/v as fp32 in
// shared memory and runs the same fp32 FMA loops (attention_common.cuh says
// how it rounds), so it is bound the same way: far from the bf16 tensor-core
// rate its time is measured against. Design: one block owns TQ query rows of one image; the [TQ, N]
// logits of a head stay in shared memory from the q k^T product through the
// softmax to the P v product, so no [N, N] matrix of a head reaches device
// memory. With weights, the block loops over all heads and adds each head's
// rows onto its own rows of the head-mean in device memory (L2-resident;
// the TPU kernel carried this sum across its sequential head grid axis,
// which GPU blocks cannot); without weights, each block takes one head, for
// more blocks in flight. Keys and values stream through shared memory in
// 64-row chunks; each thread holds a (TQ/16) x 4 tile of the product. Any N
// fits while one [TQ, N] row buffer fits in shared memory (N up to ~3200).
#include "attention_common.cuh"

namespace excel {

template <int D, int TQ, typename T>
__global__ void __launch_bounds__(kThreads)
    plain_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ ctx,
                           float* weights, int H, int N, int mode,
                           int heads_per_block, float scale) {
  extern __shared__ float smem[];
  const int stride = row_stride(N);
  float* S = smem;
  float* As = S + TQ * stride;
  float* Bs = As + TQ * tile_stride<D>();

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TQ;
  const int h0 = blockIdx.z * heads_per_block;
  const int rows = min(TQ, N - r0);
  float* wrows = mode ? weights + ((size_t)b * N + r0) * N : nullptr;

  for (int h = h0; h < h0 + heads_per_block; ++h) {
    const size_t base = ((size_t)b * H + h) * N * D;
    __syncthreads();
    stage_rows<D>(As, q + base, r0, TQ, N);
    logits_rows<D, TQ>(S, stride, As, Bs, k + base, N, scale);
    // head-mean rows, updated by the same thread for every head, in order
    softmax_rows<TQ, true, T>(S, stride, N, [&](int r, int j, float p) {
      if (mode && r < rows) {
        float* w = wrows + (size_t)r * N + j;
        *w = ((h == 0 && mode == 1) ? 0.f : *w) + p / (float)H;
      }
    });
    pv_rows<D, TQ>(ctx + base, r0, N, S, stride, Bs, v + base);
  }
}

template <int D, int TQ, typename T>
static cudaError_t launch(const T* q, const T* k, const T* v, T* ctx,
                          float* weights, int B, int H, int N, int mode,
                          size_t smem, cudaStream_t stream) {
  auto kern = plain_attention_kernel<D, TQ, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int hpb = mode ? H : 1;
  dim3 grid((N + TQ - 1) / TQ, B, H / hpb);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, ctx, weights, H, N, mode,
                                         hpb, (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

template <typename T>
static int dispatch(const T* q, const T* k, const T* v, T* ctx,
                    float* weights, int B, int H, int N, int D, int mode,
                    void* stream) {
  size_t smem = 0;
  const int tq = pick_tile(N, D, &smem);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64 && tq == 32)
    return launch<64, 32>(q, k, v, ctx, weights, B, H, N, mode, smem, s);
  if (D == 64 && tq == 16)
    return launch<64, 16>(q, k, v, ctx, weights, B, H, N, mode, smem, s);
  if (D == 32 && tq == 32)
    return launch<32, 32>(q, k, v, ctx, weights, B, H, N, mode, smem, s);
  if (D == 32 && tq == 16)
    return launch<32, 16>(q, k, v, ctx, weights, B, H, N, mode, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace excel

// q, k, v, ctx: [B, H, N, D] of the entry point's type; weights [B, N, N]
// fp32. mode: 0 none (weights unused), 1 out (weights written), 2 acc
// (weights read and updated in place). Returns a cudaError_t (0 on success).
extern "C" int excel_plain_attention_f32(const float* q, const float* k,
                                         const float* v, float* ctx,
                                         float* weights, int B, int H, int N,
                                         int D, int mode, void* stream) {
  return excel::dispatch(q, k, v, ctx, weights, B, H, N, D, mode, stream);
}

extern "C" int excel_plain_attention_bf16(const __nv_bfloat16* q,
                                          const __nv_bfloat16* k,
                                          const __nv_bfloat16* v,
                                          __nv_bfloat16* ctx, float* weights,
                                          int B, int H, int N, int D,
                                          int mode, void* stream) {
  return excel::dispatch(q, k, v, ctx, weights, B, H, N, D, mode, stream);
}
