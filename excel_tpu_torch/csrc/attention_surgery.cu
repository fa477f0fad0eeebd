// ExCEL surgery (dual-path) attention, for fp32 and bf16 q/k/v (fp32 head
// sums either way).
//
// Replaces the TPU kernel excel_tpu/models/attention_pallas.py `_kernel`
// (:244, called by fused_surgery_attention for N <= 640); it takes any N,
// so it also computes what `_kernel_rows` (:295, the row-chunked grid for
// N > 640) computes.
//
// Per image b and head h, with s = D^-1/2:
//   attn_ori = softmax(q k^T s)
//   mix      = (softmax(q q^T s) + softmax(k k^T s) + softmax(v v^T s)) / 3
//              (+ ex[b] when given)
//   shared[b]    = sum_h mix
//   attn_sum[b]  = sum_h attn_ori   (mode out; mode acc adds onto it in place)
//   ctx_ori[b,h] = attn_ori v
// The dense context shared @ v stays a separate product outside the kernel.
//
// The function needs 5 products of 2 N^2 D a head (19.8 GFLOP a launch at
// B=16, H=12, N=401, D=64) against about 110 MB of inputs and outputs
// (70 MB in bf16): bound by operations in fp32 (0.295 ms at 67 TFLOP/s) and
// by bytes in bf16 on the tensor cores.
//
// Design (attention_common.cuh): the rows kernel (one block for 64 query
// rows of one head) writes ctx_ori and the row statistics of the four
// softmaxes; the sums kernel forms one 64 x 64 patch of `shared` and
// `attn_sum` a block, adding the terms of every head in registers, heads in
// order (mode none leaves softmax(q k^T) out), and writes each once: + H ex
// read once, mode acc adds the accumulator it reads once. Each softmax
// enters the mix as p x (1 / s) x (1 / 3), which rounds differently from
// (a + b + c) / 3 by about an ulp of the sum. bf16: tensor cores
// (attention_mma.cuh), 10 products a head, bound by the softmaxes'
// exponentials (9 a logit and head); fp32: FFMA (attention_fma.cuh), bound
// by fp32 FMA throughput over those 10 products.
#include "attention_fma.cuh"
#include "attention_mma.cuh"

namespace excel {

// NS: the type's kernels (fma or tc), which share their launchers'
// signatures.
#define EXCEL_SURGERY_DISPATCH(NS, T)                                        \
  template <int D>                                                           \
  static int surgery_dispatch(const T* q, const T* k, const T* v,            \
                              const float* ex, float* shared,                \
                              float* attn_sum, T* ctx_ori, float* stats,     \
                              int B, int H, int N, int mode,                 \
                              cudaStream_t s) {                              \
    if (stats == nullptr) return (int)cudaErrorInvalidValue;                 \
    cudaError_t err =                                                        \
        NS::launch_rows<D, true>(q, k, v, ctx_ori, stats, B, H, N, s);       \
    if (err != cudaSuccess) return (int)err;                                 \
    if (mode == 0)                                                           \
      return (int)NS::launch_sums<D, false, true>(                           \
          q, k, v, stats, ex, shared, nullptr, B, H, N, mode, 1.0f, s);      \
    return (int)NS::launch_sums<D, true, true>(                              \
        q, k, v, stats, ex, shared, attn_sum, B, H, N, mode, 1.0f, s);       \
  }

EXCEL_SURGERY_DISPATCH(fma, float)
EXCEL_SURGERY_DISPATCH(tc, __nv_bfloat16)
#undef EXCEL_SURGERY_DISPATCH

template <typename T>
static int surgery_entry(const T* q, const T* k, const T* v, const float* ex,
                         float* shared, float* attn_sum, T* ctx_ori,
                         float* stats, int B, int H, int N, int D, int mode,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return surgery_dispatch<64>(q, k, v, ex, shared, attn_sum, ctx_ori, stats,
                                B, H, N, mode, s);
  if (D == 32)
    return surgery_dispatch<32>(q, k, v, ex, shared, attn_sum, ctx_ori, stats,
                                B, H, N, mode, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace excel

// q, k, v, ctx_ori: [B, H, N, D] of the entry point's type; ex, shared,
// attn_sum: [B, N, N] fp32. mode: 0 none (attn_sum unused), 1 out (attn_sum
// written), 2 acc (attn_sum read and updated in place). ex may be null.
// stats: fp32 scratch [B, H, N, 8] (row statistics from the rows kernel to
// the sums kernel). Returns a cudaError_t (0 on success).
extern "C" int excel_surgery_attention_f32(const float* q, const float* k,
                                           const float* v, const float* ex,
                                           float* shared, float* attn_sum,
                                           float* ctx_ori, float* stats,
                                           int B, int H, int N, int D,
                                           int mode, void* stream) {
  return excel::surgery_entry(q, k, v, ex, shared, attn_sum, ctx_ori, stats,
                              B, H, N, D, mode, stream);
}

extern "C" int excel_surgery_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const float* ex, float* shared, float* attn_sum, __nv_bfloat16* ctx_ori,
    float* stats, int B, int H, int N, int D, int mode, void* stream) {
  return excel::surgery_entry(q, k, v, ex, shared, attn_sum, ctx_ori, stats,
                              B, H, N, D, mode, stream);
}
