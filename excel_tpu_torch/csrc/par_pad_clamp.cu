// Fused valid-extent clamp and edge pad of a PAR canvas, fp32 and bf16.
//
// Replaces the TPU kernel excel_tpu/ops/par_pallas.py `_pad_clamp_kernel`
// (:845, called by pad_replicate_valid), which computes
// pad_for_diffuse(_replicate_valid(x, valid_hw), pad) with its alignment
// slack filled by the replicated border:
//
//   out[b, c, Y, X] = x[b, c, clamp(Y - P, 0, vh - 1), clamp(X - P, 0, vw - 1)]
//
// for every Y < Hp = H + 2P + 8 and X < Wp = roundup128(W + 2P), with
// (vh, vw) = valid_hw[b]. The TPU kernel extracts the border row and column
// with one-hot sums; a sum of one value and zeros is that value, so the
// clamped read is the same number and the two agree bit for bit.
//
// What bounds it: device memory. Each output element is written once and
// each valid input element read about once (the replicated border is read
// again from L1/L2). Design: one thread per output element, threads along X,
// so the writes and the reads of a row are coalesced; no arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pad_clamp_kernel(const T* __restrict__ x, const int* __restrict__ valid,
                     T* __restrict__ out, int C, int H, int W, int P, int Hp,
                     int Wp) {
  const int X = blockIdx.x * kThreads + threadIdx.x;
  const int Y = blockIdx.y;
  const int bc = blockIdx.z;  // b * C + c
  if (X >= Wp) return;
  const int b = bc / C;
  const int vh = min(max(__ldg(valid + 2 * b), 1), H);
  const int vw = min(max(__ldg(valid + 2 * b + 1), 1), W);
  const int y = min(max(Y - P, 0), vh - 1);
  const int xx = min(max(X - P, 0), vw - 1);
  out[((size_t)bc * Hp + Y) * Wp + X] = x[((size_t)bc * H + y) * W + xx];
}

template <typename T>
int launch(const T* x, const int* valid, T* out, int B, int C, int H, int W,
           int P, int Hp, int Wp, void* stream) {
  dim3 grid((Wp + kThreads - 1) / kThreads, Hp, B * C);
  pad_clamp_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, valid, out, C, H, W, P, Hp, Wp);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, C, H, W]; valid: [B, 2] int32 (vh, vw); out: [B, C, Hp, Wp] with
// Hp = H + 2P + 8 and Wp = roundup128(W + 2P), all on the device. Returns a
// cudaError_t (0 on success).
extern "C" int excel_pad_clamp_f32(const float* x, const int* valid,
                                   float* out, int B, int C, int H, int W,
                                   int P, void* stream) {
  return launch(x, valid, out, B, C, H, W, P, H + 2 * P + 8,
                (W + 2 * P + 127) / 128 * 128, stream);
}

extern "C" int excel_pad_clamp_bf16(const __nv_bfloat16* x, const int* valid,
                                    __nv_bfloat16* out, int B, int C, int H,
                                    int W, int P, void* stream) {
  return launch(x, valid, out, B, C, H, W, P, H + 2 * P + 8,
                (W + 2 * P + 127) / 128 * 128, stream);
}
