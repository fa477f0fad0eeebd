// EVA-02's SwiGLU gate and its sub-LayerNorm in one pass, fp32 and bf16
// (models/layers.swiglu_gate_fused).
//
// Replaces no Pallas kernel: the JAX package runs no EVA-02 tower. Between
// the SwiGLU's two products PyTorch would run the bias add over [B, N, 2h],
// silu, the product and the LayerNorm chain (cast, mean, var, four
// elementwise passes, cast back), each a read and a write of the hidden.
//
// For the W1|W2 product u [rows, 2 hp] before its bias (a in columns
// [0, h), b in [hp, hp + h); hp >= h, the columns beyond h zero padding of
// models/params.pad_swiglu) and its bias [2 hp], column j < h of a row:
//   x = T(a_j + b1_j), g = T(x / (1 + exp(-x))), y = T(b_j + b2_j),
//   m_j = T(g y),
//   out_j = T(((m_j - mean) * rstd) * scale_j + shift_j),
// mean and rstd = rsqrt(var + eps) (correction 0) over the row's h values
// m_j; out_j = 0 for h <= j < hp. Each op is rounded as the plain version's
// PyTorch ops round it (layers.swiglu_gate: the bias add in T, silu formed
// in fp32 and rounded once, the product rounded, then layers.layer_norm's
// arithmetic in fp32 over the rounded m; __f*_rn: no FMA contraction);
// only the order of the sums differs from PyTorch's reductions, and expf
// is CUDA's (PyTorch's CUDA silu calls the same function).
//
// What bounds it: device memory, 2 hp read and hp written a row: at
// EVA-02's lam batch [4 x 577, 2 x 2736] in bf16 37.9 MB, 11.3 us at
// 3.35 TB/s. Design: a block a row, the row in registers: each m_j, a
// value of T, is kept packed in T (bf16: 2 a register). Thread t takes
// 16-byte vectors t, t + threads, ... (8 bf16 or 4 fp32 elements: hp a
// multiple of them and the pointers 16-byte aligned, else the launch is
// refused; models/params.pad_swiglu pads 2,730 to 2,736), and issues all
// its loads of u before the arithmetic.
// bf16: 128 threads a row, 32 elements a thread; fp32: 256 threads, 16
// elements (hp up to 4,096 either way); at most 64 registers a thread, 8
// bf16 rows (4 fp32 rows) an SM. The sums by warp shuffles, then the
// warps' partial sums in shared memory in a fixed order: a launch gives
// the same bits every time. It runs at 42% of the bound at bf16 [2308,
// 2 x 2736] (0.0267 ms), as did 128 threads holding m in fp32 (3 rows an
// SM, 0.0264) and 256 threads (4 rows an SM, 0.0261-0.0270): how many
// rows wait at once does not hold it. Each element also takes an exact
// expf and an IEEE division in the pass (PERF.md section 7).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHidden = 4096;
constexpr int kRegsPerThread = 64;

// threads a row (a block) for elements of T: 16 fp32 or 32 bf16 elements
// a thread
template <typename T>
struct Threads {
  static constexpr int value = sizeof(T) == 2 ? 128 : 256;
};

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
  using R = uint4;
  static __device__ __forceinline__ void unpack(R r, float (&v)[W]) {
    const T* t = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = to_float(t[e]);
  }
  static __device__ __forceinline__ R pack(const float (&v)[W]) {
    R r;
    T* t = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int e = 0; e < W; ++e) t[e] = from_float<T>(v[e]);
    return r;
  }
};

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, d));
  return a;
}

// the block's sum of a over its kWarps warps, the same bits in every
// thread
template <int kWarps>
__device__ __forceinline__ float block_sum(float a, float* part) {
  a = warp_sum(a);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = a;
  __syncthreads();
  float t = part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, part[w]);
  __syncthreads();  // part is written again by the next sum
  return t;
}

template <typename T>
__global__ void __launch_bounds__(Threads<T>::value,
                                  65536 / kRegsPerThread / Threads<T>::value)
    swiglu_gate_kernel(const T* __restrict__ u, const T* __restrict__ bias,
                       T* __restrict__ out, const float* __restrict__ scale,
                       const float* __restrict__ shift, int h, int hp,
                       float eps) {
  using V = Vec<T>;
  using R = typename V::R;
  constexpr int W = V::W;
  constexpr int kThreads = Threads<T>::value;
  constexpr int kWarps = kThreads / 32;
  constexpr int kVecs = kMaxHidden / kThreads / W;  // vectors a thread
  __shared__ float part[kWarps];
  const int nvec = hp / W;
  const R* ua = reinterpret_cast<const R*>(u + (size_t)blockIdx.x * 2 * hp);
  const R* ub = ua + nvec;
  const R* ba = reinterpret_cast<const R*>(bias);
  const R* bb = ba + nvec;
  R* o = reinterpret_cast<R*>(out + (size_t)blockIdx.x * hp);

  R ra[kVecs], rb[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = k * kThreads + threadIdx.x;
    if (c < nvec) {
      ra[k] = __ldcs(ua + c);
      rb[k] = __ldcs(ub + c);
    }
  }

  // m_j, rounded to T, kept packed in T; 0 beyond h
  R mq[kVecs];
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = k * kThreads + threadIdx.x;
    if (c < nvec) {
      float a[W], b[W], b1[W], b2[W], m[W];
      V::unpack(ra[k], a);
      V::unpack(rb[k], b);
      V::unpack(__ldg(ba + c), b1);
      V::unpack(__ldg(bb + c), b2);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float x = round_to<T>(__fadd_rn(a[e], b1[e]));
        const float g = round_to<T>(__fdiv_rn(x, __fadd_rn(1.f, expf(-x))));
        const float y = round_to<T>(__fadd_rn(b[e], b2[e]));
        m[e] = c * W + e < h ? round_to<T>(__fmul_rn(g, y)) : 0.f;
        total = __fadd_rn(total, m[e]);
      }
      mq[k] = V::pack(m);
    }
  }
  const float cols = (float)h;
  const float mean = __fdiv_rn(block_sum<kWarps>(total, part), cols);

  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = k * kThreads + threadIdx.x;
    if (c < nvec) {
      float m[W];
      V::unpack(mq[k], m);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        if (c * W + e < h) {
          const float d = __fsub_rn(m[e], mean);
          sq = fmaf(d, d, sq);
        }
      }
    }
  }
  // rsqrtf: the function torch.rsqrt computes for fp32 on the card
  const float rstd =
      rsqrtf(__fadd_rn(__fdiv_rn(block_sum<kWarps>(sq, part), cols), eps));

#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int c = k * kThreads + threadIdx.x;
    if (c < nvec) {
      float m[W], v[W];
      V::unpack(mq[k], m);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const int j = c * W + e;
        v[e] = j < h ? __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(m[e], mean),
                                                     rstd),
                                           __ldg(scale + j)),
                                 __ldg(shift + j))
                     : 0.f;
      }
      o[c] = V::pack(v);
    }
  }
}

template <typename T>
int launch(const void* u, const void* bias, void* out, const float* scale,
           const float* shift, int rows, int h, int hp, float eps,
           void* stream) {
  if (rows < 1 || h < 1 || hp < h || hp > kMaxHidden || u == nullptr ||
      bias == nullptr || out == nullptr || scale == nullptr ||
      shift == nullptr || (hp * sizeof(T)) % 16 != 0 ||
      ((uintptr_t)u | (uintptr_t)bias | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  swiglu_gate_kernel<T><<<rows, Threads<T>::value, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)bias, (T*)out, scale, shift, h, hp, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// u: [rows, 2 hp] (a's columns, then b's), bias: [2 hp], out: [rows, hp],
// contiguous, of the entry point's type, on the device, 16-byte aligned;
// hp a multiple of 16 bytes; scale, shift: fp32 [h]; 1 <= h <= hp <= 4,096.
// Returns a cudaError_t (0 on success).
extern "C" int excel_swiglu_gate_bf16(const void* u, const void* bias,
                                      void* out, const float* scale,
                                      const float* shift, int rows, int h,
                                      int hp, float eps, void* stream) {
  return launch<__nv_bfloat16>(u, bias, out, scale, shift, rows, h, hp, eps,
                               stream);
}

extern "C" int excel_swiglu_gate_f32(const void* u, const void* bias,
                                     void* out, const float* scale,
                                     const float* shift, int rows, int h,
                                     int hp, float eps, void* stream) {
  return launch<float>(u, bias, out, scale, shift, rows, h, hp, eps, stream);
}
