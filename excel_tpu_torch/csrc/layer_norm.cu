// The encoder's residual add and LayerNorm in one pass, fp32 and bf16
// (models/layers.layer_norm_fused and add_layer_norm_fused).
//
// Replaces no Pallas kernel: the JAX package leaves the residual adds and
// LayerNorm to XLA, which fuses them itself. In the port they were a chain
// of PyTorch kernels: the bf16 residual add, the cast to fp32, mean, var,
// four fp32 elementwise passes and the cast back, ~58 bytes of device
// traffic a bf16 element, 2L + 2 times an encoder pass.
//
// For rows of width C:
//   residual form: s = x + y rounded to T, and out = LayerNorm(s); both are
//                  written (s is the residual stream the next block adds to);
//   plain form:    out = LayerNorm(x) (y, s null).
// The numerics are the plain version's (models/layers.layer_norm): the sum
// formed in fp32 and rounded once to T, torch's x + y bit for bit; the mean
// and the variance (correction 0) in fp32 over the rounded row, in two
// passes over the row held in registers; then
// ((s - mean) * rsqrt(var + eps)) * scale + bias, each op rounded on its own
// as the plain version's separate kernels round it (__f*_rn: nvcc would
// otherwise contract the multiply and add into an FMA), and rounded once
// to T. Only the order of the two sums differs from PyTorch's reductions.
//
// What bounds it: device memory. The residual form reads x and y and writes
// s and out, 8 bytes a bf16 element: at ViT-H/14's [4, 577, 1280] 23.6 MB,
// 7.0 us at 3.35 TB/s; the plain form half that. Design: one warp a row,
// the row in registers as fp32 (VPL 16-byte vectors a lane; lane l holds
// vectors l, l + 32, ..., so each warp load or store is 512 contiguous
// bytes); the sums by butterflies of warp shuffles, after which every lane
// holds the same bits; no shared memory, no atomics, so a launch gives the
// same bits every time. kWarps rows a block: ViT-B's 1,604 rows and
// ViT-H's 2,308 run in one wave over the 132 SMs. scale and bias (fp32, C
// each, read by every row from L1 / L2) load as float4 where both are
// 16-byte aligned, else one by one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // rows a block
// 16-byte vectors a lane at most: C up to 4,096 in bf16, 2,048 in fp32
constexpr int kMaxVecs = 16;

// 16 bytes as E floats: 8 bf16 or 4 fp32 elements, and rounding to T
template <int E>
struct Io;

template <>
struct Io<8> {
  static __device__ __forceinline__ void unpack(uint4 q, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return q;
  }
  static __device__ __forceinline__ float round(float a) {
    return __bfloat162float(__float2bfloat16_rn(a));
  }
};

template <>
struct Io<4> {
  static __device__ __forceinline__ void unpack(uint4 q, float (&v)[4]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ float round(float a) { return a; }
};

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, d));
  return a;
}

// p[i .. i + E) of an fp32 parameter vector
template <int E>
__device__ __forceinline__ void load_params(const float* __restrict__ p,
                                            int i, bool vec,
                                            float (&g)[E]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i) + k);
      g[4 * k] = q.x;
      g[4 * k + 1] = q.y;
      g[4 * k + 2] = q.z;
      g[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) g[e] = __ldg(p + i + e);
  }
}

template <int E, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
                      uint4* __restrict__ sum, uint4* __restrict__ out,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, int rows, int nvec,
                      float eps, bool vec_params) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: the shuffles keep full masks
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)row * nvec;
  const float cols = (float)(nvec * E);

  float v[VPL][E];
  float total = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = j * 32 + lane;
    if (c < nvec) {
      Io<E>::unpack(__ldg(x + base + c), v[j]);
      if (y != nullptr) {
        float w[E];
        Io<E>::unpack(__ldg(y + base + c), w);
#pragma unroll
        for (int e = 0; e < E; ++e)
          v[j][e] = Io<E>::round(__fadd_rn(v[j][e], w[e]));
        sum[base + c] = Io<E>::pack(v[j]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) total = __fadd_rn(total, v[j][e]);
    }
  }
  const float mean = __fdiv_rn(warp_sum(total), cols);

  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    if (j * 32 + lane < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = __fsub_rn(v[j][e], mean);
        sq = fmaf(d, d, sq);
      }
    }
  }
  // rsqrtf: the function torch.rsqrt computes for fp32 on the card
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), cols), eps));

#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = j * 32 + lane;
    if (c < nvec) {
      float g[E], b[E];
      load_params<E>(scale, c * E, vec_params, g);
      load_params<E>(bias, c * E, vec_params, b);
#pragma unroll
      for (int e = 0; e < E; ++e)
        v[j][e] = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[j][e], mean), rstd), g[e]), b[e]);
      out[base + c] = Io<E>::pack(v[j]);
    }
  }
}

// launches the instance for `vpl` vectors a lane
template <int E, int VPL>
int dispatch(int vpl, const uint4* x, const uint4* y, uint4* sum, uint4* out,
             const float* scale, const float* bias, int rows, int nvec,
             float eps, bool vec_params, cudaStream_t stream) {
  if (vpl == VPL) {
    layer_norm_kernel<E, VPL><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0,
                                stream>>>(x, y, sum, out, scale, bias, rows,
                                          nvec, eps, vec_params);
    return (int)cudaGetLastError();
  }
  if constexpr (VPL < kMaxVecs)
    return dispatch<E, VPL + 1>(vpl, x, y, sum, out, scale, bias, rows, nvec,
                                eps, vec_params, stream);
  return (int)cudaErrorInvalidValue;
}

bool misaligned(const void* p) { return ((uintptr_t)p & 15) != 0; }

template <int E>
int launch(const void* x, const void* y, void* sum, void* out,
           const float* scale, const float* bias, int rows, int cols,
           float eps, void* stream) {
  if (rows < 1 || cols < E || cols % E != 0 || cols / E > 32 * kMaxVecs ||
      x == nullptr || out == nullptr || scale == nullptr || bias == nullptr ||
      (y == nullptr) != (sum == nullptr) || misaligned(x) || misaligned(y) ||
      misaligned(sum) || misaligned(out))
    return (int)cudaErrorInvalidValue;
  const int nvec = cols / E;
  const bool vec_params = !misaligned(scale) && !misaligned(bias);
  return dispatch<E, 1>((nvec + 31) / 32, (const uint4*)x, (const uint4*)y,
                        (uint4*)sum, (uint4*)out, scale, bias, rows, nvec, eps,
                        vec_params, (cudaStream_t)stream);
}

}  // namespace

// x, y, sum, out: [rows, cols] contiguous, 16-byte aligned, on the device;
// y and sum both null for the plain form; cols a multiple of 8 (bf16) or 4
// (fp32), at most 4,096 / 2,048; scale, bias: fp32 [cols], any alignment.
// Returns a cudaError_t (0 on success).
extern "C" int excel_layer_norm_bf16(const void* x, const void* y, void* sum,
                                     void* out, const float* scale,
                                     const float* bias, int rows, int cols,
                                     float eps, void* stream) {
  return launch<8>(x, y, sum, out, scale, bias, rows, cols, eps, stream);
}

extern "C" int excel_layer_norm_f32(const void* x, const void* y, void* sum,
                                    void* out, const float* scale,
                                    const float* bias, int rows, int cols,
                                    float eps, void* stream) {
  return launch<4>(x, y, sum, out, scale, bias, rows, cols, eps, stream);
}
