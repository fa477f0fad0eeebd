// The encoder MLP's fc bias add and activation in one pass, fp32 and bf16:
// QuickGELU (OpenAI's ViT-B/16), exact GELU (OpenCLIP's ViT-H/14) or tanh
// GELU (SigLIP So400m/14's gelu_pytorch_tanh) (models/layers.fc_act_fused).
//
// Replaces no Pallas kernel: the JAX package leaves the bias add and the
// activation to XLA, which fuses them into its own kernels. In the port
// they were PyTorch's broadcast bias add over the fc product [n, hidden],
// then the activation's passes over it: exact GELU one, QuickGELU seven
// (x 1.702, negate, exp, + 1, reciprocal, x 1.0, x the input), each a read
// and a write of the hidden activations, L times an encoder pass.
//
// For the fc product u [rows, hidden] (before its bias) and the bias
// [hidden], each element, with T the tensors' type and T(.) a rounding to
// it (round to nearest even), as PyTorch's ops round them:
//   z = T(u + b);
//   QuickGELU: t = T(a z) with a = T(1.702), e = T(exp(-t)),
//              d = T(1 + e), r = T(1 / d), out = T(z r);
//   exact GELU: out = T(z 0.5 (1 + erf(z sqrt(1/2)))) in fp32;
//   tanh GELU: out = T(0.5 z (1 + tanh(b (z + k z^3)))) in fp32, b =
//              sqrt(2) (2 / sqrt(pi)) / 2, k = 0.044715.
// QuickGELU is layers.quick_gelu, op for op; the trailing x 1.0 of its
// `1.0 / d` (reciprocal, then times 1.0) is exact and left out. Sums and
// products are __f*_rn (no FMA contraction), the exponential is CUDA's
// expf and the division IEEE's, the functions PyTorch's exp and reciprocal
// call on the card. Exact GELU is PyTorch's own expression
// (GeluCUDAKernelImpl) written as it writes it, so nvcc treats it alike,
// and so is tanh GELU (its approximate="tanh" branch: the constants formed
// in double and rounded to fp32, the cube as two products, tanhf).
// So the output is the plain chain's bit for bit (tests/
// test_torch_kernels_gpu.py holds it so).
//
// What bounds it: device memory, one read of u and one write of the output:
// at ViT-H/14's lam batch [2308, 5120] in bf16 47.3 MB, 14.1 us at 3.35
// TB/s; at ViT-B/16's [1604, 3072] 19.7 MB, 5.9 us. The arithmetic comes
// close to it: exact GELU's erff and QuickGELU's expf, IEEE division and
// five roundings are 25-35 instructions an element, ~12 us of the SMs'
// issue slots at ViT-H's batch. Design: a thread moves one 16-byte vector
// (8 bf16 or 4 fp32 elements) of one row: one load of u, one of the bias
// (which stays in L1 and L2), one store. A block is kThreads consecutive
// vectors of a row (grid: rows x column blocks), so each warp load and
// store is 512 contiguous bytes. One vector a thread, rather than a column
// of 2, 4 or 8 rows with all loads issued first, was the fastest of those
// at every shape (H100: ViT-B's bf16 QuickGELU 0.0127 ms against 0.0145,
// 0.0172, 0.0188; ViT-H's bf16 GELU 0.0204 against 0.0203-0.0211): the
// thread's arithmetic, not the loads in flight, is what waits. u is read
// with the evict-first hint (it is read once), so that L2 keeps the output
// that the proj GEMM reads next. hidden must be a whole number of 16-byte
// vectors and the pointers 16-byte aligned, else the launch is refused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQuickGelu = 0, kGelu = 1, kGeluTanh = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, as a float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// the W = 16 / sizeof(T) elements of T moved as one 16-byte load or store
template <typename T>
struct Vec {
  static constexpr int W = 16 / sizeof(T);
  static __device__ __forceinline__ void unpack(uint4 r, float (&v)[W]) {
    const T* t = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = to_float(t[e]);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[W]) {
    uint4 r;
    T* t = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int e = 0; e < W; ++e) t[e] = from_float<T>(v[e]);
    return r;
  }
};

// layers.quick_gelu of z (a value of T), before the last rounding
template <typename T>
__device__ __forceinline__ float quick_gelu(float z) {
  // 1.702 rounded to T: the fp32 literal rounds to 1.702 in bf16 as the
  // Python float does (1.703125)
  const float a = round_to<T>(1.702f);
  const float t = round_to<T>(__fmul_rn(a, z));
  const float e = round_to<T>(expf(-t));
  const float d = round_to<T>(__fadd_rn(1.f, e));
  const float r = round_to<T>(__fdiv_rn(1.f, d));
  return __fmul_rn(z, r);
}

// F.gelu of z in fp32, as PyTorch's CUDA kernel writes it, before the last
// rounding
__device__ __forceinline__ float gelu(float z) {
  constexpr float kAlpha = 0.70710678118654752440f;  // M_SQRT1_2
  return z * 0.5f * (1.f + erff(z * kAlpha));
}

// F.gelu(z, approximate="tanh") in fp32, as PyTorch's CUDA kernel writes
// it, before the last rounding
__device__ __forceinline__ float gelu_tanh(float z) {
  // M_SQRT2 * M_2_SQRTPI * 0.5 and 0.044715, formed in double
  constexpr float kBeta =
      1.41421356237309504880 * 1.12837916709551257390 * 0.5;
  constexpr float kKappa = 0.044715;
  const float x_cube = z * z * z;
  const float inner = kBeta * (z + kKappa * x_cube);
  return 0.5f * z * (1.f + tanhf(inner));
}

template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads)
    fc_act_kernel(const T* __restrict__ u, const T* __restrict__ bias,
                  T* __restrict__ out, int row_vecs) {
  using V = Vec<T>;
  constexpr int W = V::W;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= row_vecs) return;
  const size_t at = (size_t)blockIdx.x * row_vecs + c;
  float v[W], b[W];
  V::unpack(__ldcs(reinterpret_cast<const uint4*>(u) + at), v);
  V::unpack(__ldg(reinterpret_cast<const uint4*>(bias) + c), b);
#pragma unroll
  for (int e = 0; e < W; ++e) {
    const float z = round_to<T>(__fadd_rn(v[e], b[e]));
    v[e] = kAct == kQuickGelu ? quick_gelu<T>(z)
                              : (kAct == kGelu ? gelu(z) : gelu_tanh(z));
  }
  reinterpret_cast<uint4*>(out)[at] = V::pack(v);
}

template <typename T>
int launch(const void* u, const void* bias, void* out, int rows, int hidden,
           int act, void* stream) {
  constexpr int W = 16 / sizeof(T);
  if (rows < 1 || hidden < W || hidden % W != 0 ||
      (act != kQuickGelu && act != kGelu && act != kGeluTanh) ||
      u == nullptr ||
      bias == nullptr || out == nullptr ||
      ((uintptr_t)u | (uintptr_t)bias | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int row_vecs = hidden / W;
  const dim3 grid(rows, (row_vecs + kThreads - 1) / kThreads);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (act == kQuickGelu)
    fc_act_kernel<T, kQuickGelu><<<grid, kThreads, 0, s>>>(
        (const T*)u, (const T*)bias, (T*)out, row_vecs);
  else if (act == kGelu)
    fc_act_kernel<T, kGelu><<<grid, kThreads, 0, s>>>(
        (const T*)u, (const T*)bias, (T*)out, row_vecs);
  else
    fc_act_kernel<T, kGeluTanh><<<grid, kThreads, 0, s>>>(
        (const T*)u, (const T*)bias, (T*)out, row_vecs);
  return (int)cudaGetLastError();
}

}  // namespace

// u: [rows, hidden] (the fc product), bias: [hidden], out: [rows, hidden],
// contiguous, of the entry point's type, on the device, 16-byte aligned;
// hidden a whole number of 16-byte vectors; act 0 QuickGELU, 1 exact GELU,
// 2 tanh GELU.
// Returns a cudaError_t (0 on success).
extern "C" int excel_fc_act_bf16(const void* u, const void* bias, void* out,
                                 int rows, int hidden, int act,
                                 void* stream) {
  return launch<__nv_bfloat16>(u, bias, out, rows, hidden, act, stream);
}

extern "C" int excel_fc_act_f32(const void* u, const void* bias, void* out,
                                int rows, int hidden, int act, void* stream) {
  return launch<float>(u, bias, out, rows, hidden, act, stream);
}
