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
// At the encoder's shapes (B=16, H=12, N=401, D=64) the function needs 2
// products of 2 N^2 D a head, 7.9 GFLOP, against 79 MB of q/k/v/ctx (40 MB
// in bf16) and 10 MB of weights: bound by operations in fp32 (0.118 ms at
// the CUDA cores' 67 TFLOP/s), by bytes in bf16 on the tensor cores.
//
// Design (attention_common.cuh): without weights one launch of the rows
// kernel, one block for 64 query rows of one head, the exact softmax in two
// passes over the keys with the logits formed twice, so neither a row
// buffer nor the [N, N] matrix of a head exists. With weights the rows
// kernel also writes each row's softmax statistics, and the sums kernel
// forms the head-mean of one 64 x 64 patch a block in registers, heads in
// order, and writes it once (x 1 / H; mode acc adds the accumulator it
// reads once). bf16: tensor cores (attention_mma.cuh), bound by the
// softmax's exponentials and the L2 reads of the key tiles. fp32: FFMA
// (attention_fma.cuh), bound by fp32 FMA throughput, with 3 products a head
// instead of 2 (4 with weights).
#include "attention_fma.cuh"
#include "attention_mma.cuh"

namespace excel {

// NS: the type's kernels (fma or tc), which share their launchers'
// signatures.
#define EXCEL_PLAIN_DISPATCH(NS, T)                                          \
  template <int D>                                                           \
  static int plain_dispatch(const T* q, const T* k, const T* v, T* ctx,      \
                            float* weights, float* stats, int B, int H,      \
                            int N, int mode, cudaStream_t s) {               \
    if (mode != 0 && stats == nullptr) return (int)cudaErrorInvalidValue;    \
    cudaError_t err = NS::launch_rows<D, false>(                             \
        q, k, v, ctx, mode ? stats : nullptr, B, H, N, s);                   \
    if (err != cudaSuccess || mode == 0) return (int)err;                    \
    return (int)NS::launch_sums<D, true, false>(                             \
        q, k, v, stats, nullptr, nullptr, weights, B, H, N, mode,            \
        1.0f / (float)H, s);                                                 \
  }

EXCEL_PLAIN_DISPATCH(fma, float)
EXCEL_PLAIN_DISPATCH(tc, __nv_bfloat16)
#undef EXCEL_PLAIN_DISPATCH

template <typename T>
static int plain_entry(const T* q, const T* k, const T* v, T* ctx,
                       float* weights, float* stats, int B, int H, int N,
                       int D, int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return plain_dispatch<64>(q, k, v, ctx, weights, stats, B, H, N, mode, s);
  if (D == 32)
    return plain_dispatch<32>(q, k, v, ctx, weights, stats, B, H, N, mode, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace excel

// q, k, v, ctx: [B, H, N, D] of the entry point's type; weights [B, N, N]
// fp32. mode: 0 none (weights unused), 1 out (weights written), 2 acc
// (weights read and updated in place). stats: fp32 scratch [B, H, N, 2]
// (row statistics from the rows kernel to the sums kernel) when mode != 0,
// else unused. Returns a cudaError_t (0 on success).
extern "C" int excel_plain_attention_f32(const float* q, const float* k,
                                         const float* v, float* ctx,
                                         float* weights, float* stats, int B,
                                         int H, int N, int D, int mode,
                                         void* stream) {
  return excel::plain_entry(q, k, v, ctx, weights, stats, B, H, N, D, mode,
                            stream);
}

extern "C" int excel_plain_attention_bf16(const __nv_bfloat16* q,
                                          const __nv_bfloat16* k,
                                          const __nv_bfloat16* v,
                                          __nv_bfloat16* ctx, float* weights,
                                          float* stats, int B, int H, int N,
                                          int D, int mode, void* stream) {
  return excel::plain_entry(q, k, v, ctx, weights, stats, B, H, N, D, mode,
                            stream);
}
