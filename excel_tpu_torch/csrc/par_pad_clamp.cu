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
// again from L1/L2): at the fast eval batch 92 MB for the fp32 images and
// 61 MB for the bf16 masks. Design (the previous one: a thread an element,
// a block a row, 2-byte stores in bf16): a thread writes 16-byte vectors
// (4 fp32 or 8 bf16) of the output, coalesced, a block 8 rows of one
// (b, c), whose extents it reads once. A vector whose sources lie in
// [0, vw) of the clamped source row is one 16-byte load where P and W are
// multiples of the vector and x is 16-byte aligned (the paths' pad 24 in
// both types); every other vector reads its clamped elements one by one.
// Stores keep the default caching: the next kernel reads the output (the
// bf16 mask canvas, 36 MB, fits the 50 MiB L2). Elements are copied as
// their bits (T: a 4- or 2-byte unsigned integer).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;   // output rows a block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pad_clamp_kernel(const T* __restrict__ x, const int* __restrict__ valid,
                     T* __restrict__ out, int C, int H, int W, int P, int Hp,
                     int Wp, bool vec_src) {
  constexpr int V = 16 / sizeof(T);
  union Vec {
    uint4 u;
    T e[V];
  };
  const int bc = blockIdx.y;  // b * C + c
  const int b = bc / C;
  const int vh = min(max(__ldg(valid + 2 * b), 1), H);
  const int vw = min(max(__ldg(valid + 2 * b + 1), 1), W);
  const int Y0 = blockIdx.x * kRows;
  const int nvec = Wp / V;
  const int total = min(kRows, Hp - Y0) * nvec;
  const T* src = x + (size_t)bc * H * W;
  uint4* dst = (uint4*)(out + ((size_t)bc * Hp + Y0) * Wp);
  // flat vector index i = r * nvec + v, stepped without a division
  int r = threadIdx.x / nvec, v = threadIdx.x - r * nvec;
  const int step_r = kThreads / nvec, step_v = kThreads - step_r * nvec;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const T* row = src + (size_t)min(max(Y0 + r - P, 0), vh - 1) * W;
    const int xs = v * V - P;
    Vec o;
    if (vec_src && xs >= 0 && xs + V <= vw) {
      o.u = __ldg((const uint4*)(row + xs));
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) o.e[j] = row[min(max(xs + j, 0), vw - 1)];
    }
    dst[i] = o.u;
    r += step_r;
    v += step_v;
    if (v >= nvec) {
      v -= nvec;
      ++r;
    }
  }
}

template <typename T>
int launch(const T* x, const int* valid, T* out, int B, int C, int H, int W,
           int P, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (B < 1 || C < 1 || H < 1 || W < 1 || P < 0 || B * C > 65535 ||
      ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int Hp = H + 2 * P + 8, Wp = (W + 2 * P + 127) / 128 * 128;
  const bool vec_src = P % V == 0 && W % V == 0 && ((uintptr_t)x & 15) == 0;
  dim3 grid((Hp + kRows - 1) / kRows, B * C);
  pad_clamp_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, valid, out, C, H, W, P, Hp, Wp, vec_src);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, C, H, W] (any alignment); valid: [B, 2] int32 (vh, vw); out:
// [B, C, Hp, Wp] with Hp = H + 2P + 8 and Wp = roundup128(W + 2P), 16-byte
// aligned; all on the device. Returns a cudaError_t (0 on success).
extern "C" int excel_pad_clamp_f32(const float* x, const int* valid,
                                   float* out, int B, int C, int H, int W,
                                   int P, void* stream) {
  return launch((const uint32_t*)x, valid, (uint32_t*)out, B, C, H, W, P,
                stream);
}

extern "C" int excel_pad_clamp_bf16(const __nv_bfloat16* x, const int* valid,
                                    __nv_bfloat16* out, int B, int C, int H,
                                    int W, int P, void* stream) {
  return launch((const uint16_t*)x, valid, (uint16_t*)out, B, C, H, W, P,
                stream);
}
