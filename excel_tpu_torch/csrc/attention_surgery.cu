// ExCEL surgery (dual-path) attention, for fp32 and bf16 q/k/v (fp32 head
// sums either way).
//
// Replaces the TPU kernel excel_tpu/models/attention_pallas.py `_kernel`
// (:244, called by fused_surgery_attention for N <= 640); it takes any N the
// shared memory holds, so it also computes what `_kernel_rows` (:295, the
// row-chunked grid for N > 640) computes.
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
// What bounds it: fp32 arithmetic, 5 products of 2*N^2*D per head (19.8
// GFLOP per launch at B=16, H=12, N=401, D=64) against about 110 MB of
// inputs and outputs. The bf16 entry point runs the same fp32 loops on
// bf16 inputs staged as fp32 (attention_common.cuh). Design: as the plain kernel, one block owns TQ query
// rows of one image and loops over the heads, adding each head's rows onto
// its own rows of the two head sums in device memory (L2-resident), so one
// [TQ, N] shared-memory buffer suffices and two blocks fit on an SM. The
// four softmax rows of a head are formed one after another in that buffer:
// the k k^T and v v^T rows use rows of k and v as their queries. The mix is
// added into the shared rows term by term (each softmax / 3), which rounds
// differently from (a + b + c) / 3 by about one ulp of the sum.
#include "attention_common.cuh"

namespace excel {

template <int D, int TQ, typename T>
__global__ void __launch_bounds__(kThreads)
    surgery_attention_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ ex,
                             float* __restrict__ shared, float* attn_sum,
                             T* __restrict__ ctx_ori, int H, int N,
                             int mode, float scale) {
  extern __shared__ float smem[];
  const int stride = row_stride(N);
  float* S = smem;
  float* As = S + TQ * stride;
  float* Bs = As + TQ * tile_stride<D>();

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TQ;
  const int rows = min(TQ, N - r0);
  const size_t rows_off = ((size_t)b * N + r0) * N;
  float* shrows = shared + rows_off;
  float* asrows = mode ? attn_sum + rows_off : nullptr;
  const float* exrows = ex ? ex + rows_off : nullptr;

  // The head sums live in device memory (L2-resident): the softmax
  // epilogues update the block's own rows, each element always from the
  // same thread and in term order, so no synchronisation is needed and the
  // result is deterministic.
  for (int h = 0; h < H; ++h) {
    const size_t base = ((size_t)b * H + h) * N * D;
    // original path: softmax(q k^T), its head sum and attn_ori @ v
    __syncthreads();
    stage_rows<D>(As, q + base, r0, TQ, N);
    logits_rows<D, TQ>(S, stride, As, Bs, k + base, N, scale);
    softmax_rows<TQ, true, T>(S, stride, N, [&](int r, int j, float p) {
      if (mode && r < rows) {
        float* a = asrows + (size_t)r * N + j;
        *a = ((h == 0 && mode == 1) ? 0.f : *a) + p;
      }
    });
    pv_rows<D, TQ>(ctx_ori + base, r0, N, S, stride, Bs, v + base);
    // dense path: q q^T (As still holds the q rows), k k^T, v v^T
    for (int t = 0; t < 3; ++t) {
      const T* src = t == 0 ? q + base : (t == 1 ? k + base : v + base);
      if (t > 0) {
        __syncthreads();
        stage_rows<D>(As, src, r0, TQ, N);
      }
      logits_rows<D, TQ>(S, stride, As, Bs, src, N, scale);
      softmax_rows<TQ, false, T>(S, stride, N, [&](int r, int j, float p) {
        if (r < rows) {
          const size_t i = (size_t)r * N + j;
          float add = p / 3.0f;
          if (t == 2 && exrows) add += exrows[i];
          shrows[i] = (h == 0 && t == 0) ? add : shrows[i] + add;
        }
      });
    }
  }
}

template <int D, int TQ, typename T>
static cudaError_t launch(const T* q, const T* k, const T* v,
                          const float* ex, float* shared, float* attn_sum,
                          T* ctx_ori, int B, int H, int N, int mode,
                          size_t smem, cudaStream_t stream) {
  auto kern = surgery_attention_kernel<D, TQ, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + TQ - 1) / TQ, B, 1);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, ex, shared, attn_sum,
                                         ctx_ori, H, N, mode,
                                         (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

template <typename T>
static int dispatch(const T* q, const T* k, const T* v, const float* ex,
                    float* shared, float* attn_sum, T* ctx_ori, int B, int H,
                    int N, int D, int mode, void* stream) {
  size_t smem = 0;
  const int tq = pick_tile(N, D, &smem);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64 && tq == 32)
    return launch<64, 32>(q, k, v, ex, shared, attn_sum, ctx_ori, B, H, N,
                          mode, smem, s);
  if (D == 64 && tq == 16)
    return launch<64, 16>(q, k, v, ex, shared, attn_sum, ctx_ori, B, H, N,
                          mode, smem, s);
  if (D == 32 && tq == 32)
    return launch<32, 32>(q, k, v, ex, shared, attn_sum, ctx_ori, B, H, N,
                          mode, smem, s);
  if (D == 32 && tq == 16)
    return launch<32, 16>(q, k, v, ex, shared, attn_sum, ctx_ori, B, H, N,
                          mode, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace excel

// q, k, v, ctx_ori: [B, H, N, D] of the entry point's type; ex, shared,
// attn_sum: [B, N, N] fp32. mode: 0 none (attn_sum unused), 1 out (attn_sum
// written), 2 acc (attn_sum read and updated in place). ex may be null.
// Returns a cudaError_t (0 on success).
extern "C" int excel_surgery_attention_f32(const float* q, const float* k,
                                           const float* v, const float* ex,
                                           float* shared, float* attn_sum,
                                           float* ctx_ori, int B, int H, int N,
                                           int D, int mode, void* stream) {
  return excel::dispatch(q, k, v, ex, shared, attn_sum, ctx_ori, B, H, N, D,
                         mode, stream);
}

extern "C" int excel_surgery_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const float* ex, float* shared, float* attn_sum, __nv_bfloat16* ctx_ori,
    int B, int H, int N, int D, int mode, void* stream) {
  return excel::dispatch(q, k, v, ex, shared, attn_sum, ctx_ori, B, H, N, D,
                         mode, stream);
}
