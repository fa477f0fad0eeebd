// The encoder's qkv bias add and head split in one pass, fp32 and bf16,
// and with EVA-02's 2D rotation of q and k at the patch tokens
// (models/layers.qkv_heads_kernel).
//
// Replaces no Pallas kernel: the JAX package leaves the bias add, the split
// into q, k, v and the move of the heads in front of the tokens to XLA,
// which fuses them into its own kernels. In the port they were PyTorch's
// broadcast bias add over the qkv product [B, N, 3C] and three strided
// copies of [B, N, C] (`split_heads`), two reads and two writes of the qkv
// activations, L times an encoder pass.
//
// For the qkv product x [B, N, 3C] (before its bias), C = H D:
//   out[s, b, h, n, d] = x[b, n, s C + h D + d] + bias[s C + h D + d]
// with s = 0, 1, 2 for q, k, v: one buffer [3, B, H, N, D] whose three
// [B, H, N, D] slices are the attention kernels' q, k and v. Each element is
// float(x) + float(bias) rounded once to T (__fadd_rn, then round to
// nearest even): PyTorch's x + b in T bit for bit.
//
// The rotating entry points (EVA-02) take an fp32 table [2, N-1, D] of cos
// and sin (models/layers.rope_table: each pair of dims shares its angle)
// and turn q and k (s = 0, 1) at tokens n >= 1, the CLS token n = 0 and v
// as they are: with u = the rounded sum above, for each pair (2i, 2i + 1)
//   out[2i]     = T(u[2i] cos[2i] - u[2i+1] sin[2i])
//   out[2i + 1] = T(u[2i+1] cos[2i+1] + u[2i] sin[2i+1])
// each product and the sum rounded to fp32 on its own (__f*_rn: no FMA),
// as layers.apply_rope's PyTorch ops round them. The pairs lie within a
// thread's 16-byte vector, so the pass moves the same vectors; each
// rotated vector also reads its E cos and E sin values, from a table of
// (N-1) D x 8 bytes that stays in L2 (295 KB at EVA-02's 577 tokens) and
// is shared by every head and image: the pass writes no more bytes.
//
// What bounds it: device memory, one read and one write of [B, N, 3C]: at
// ViT-H/14's lam batch [4, 577, 3840] in bf16 35.4 MB, 10.6 us at 3.35
// TB/s; at ViT-B/16's [4, 401, 2304] 14.8 MB, 4.4 us. Design: a block
// moves a tile of kTokens tokens of one (image, q|k|v, head); a token's
// head row is D elements, VR = D x sizeof(T) / 16 vectors of 16 bytes (64,
// 128, 144 or 160 bytes, 16-byte aligned at any head: bf16 VR = 4, 8, 9, 10;
// fp32 8, 16, 18, 20; a bf16 tile of D = 72 is 576 vectors, 4.5 a thread:
// the last round's upper half of the threads has none). Thread t takes
// vectors t, t + kThreads, ... of the tile in
// the output's order, so each warp store is 512 contiguous bytes and each
// warp load covers 1.6 to 8 head rows, each contiguous; a thread issues all
// its kPer loads before its first store. The tile's kTokens x D output is one contiguous run.
// 128 threads a block: ViT-H's 10 x 48 x 4 = 1,920 blocks and ViT-B's
// 7 x 36 x 4 = 1,008 run in one wave over the 132 SMs. The product is read
// with the evict-first hint (it is read once), so that L2 keeps the output
// the attention kernels read next.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTokens = 64;  // tokens a block

// a + b of 16 bytes of E elements each, rounded to T
template <int E>
__device__ __forceinline__ uint4 add16(uint4 a, uint4 b);

template <>
__device__ __forceinline__ uint4 add16<8>(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 r;
  __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]);
    const float2 v = __bfloat1622float2(y[i]);
    z[i] = __floats2bfloat162_rn(__fadd_rn(u.x, v.x), __fadd_rn(u.y, v.y));
  }
  return r;
}

template <>
__device__ __forceinline__ uint4 add16<4>(uint4 a, uint4 b) {
  return make_uint4(
      __float_as_uint(__fadd_rn(__uint_as_float(a.x), __uint_as_float(b.x))),
      __float_as_uint(__fadd_rn(__uint_as_float(a.y), __uint_as_float(b.y))),
      __float_as_uint(__fadd_rn(__uint_as_float(a.z), __uint_as_float(b.z))),
      __float_as_uint(__fadd_rn(__uint_as_float(a.w), __uint_as_float(b.w))));
}

// 16 bytes as E floats and back, rounded to T
template <int E>
__device__ __forceinline__ void unpack16(uint4 q, float (&v)[E]);

template <>
__device__ __forceinline__ void unpack16<8>(uint4 q, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void unpack16<4>(uint4 q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}

template <int E>
__device__ __forceinline__ uint4 pack16(const float (&v)[E]);

template <>
__device__ __forceinline__ uint4 pack16<8>(const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return q;
}

template <>
__device__ __forceinline__ uint4 pack16<4>(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

// the vector u (E elements, adjacent pairs) turned by cos cs, sin sn
template <int E>
__device__ __forceinline__ uint4 rotate16(uint4 u, const float4 (&cs)[E / 4],
                                          const float4 (&sn)[E / 4]) {
  float x[E], o[E];
  unpack16<E>(u, x);
  const float* c = reinterpret_cast<const float*>(cs);
  const float* s = reinterpret_cast<const float*>(sn);
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    o[e] = __fadd_rn(__fmul_rn(x[e], c[e]), __fmul_rn(-x[e + 1], s[e]));
    o[e + 1] = __fadd_rn(__fmul_rn(x[e + 1], c[e + 1]),
                         __fmul_rn(x[e], s[e + 1]));
  }
  return pack16<E>(o);
}

// Grid (token tiles, 3 H, B): blockIdx.y = s H + h. ROPE: rope is the
// [2, N-1, D] table (cos, then sin), else unused.
template <int E, int VR, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    qkv_heads_kernel(const uint4* __restrict__ x,
                     const uint4* __restrict__ bias,
                     const float4* __restrict__ rope, uint4* __restrict__ out,
                     int B, int N, int H) {
  // vectors a thread; where kThreads does not divide the tile's, the last
  // round's vectors past the tile lie at tokens n >= kTokens: none
  constexpr int kPer = (kTokens * VR + kThreads - 1) / kThreads;
  constexpr int kQ = E / 4;  // float4s of cos (and of sin) a vector
  const int n0 = blockIdx.x * kTokens;
  const int sh = blockIdx.y;
  const int b = blockIdx.z;
  const int s = sh / H;
  const int h = sh - s * H;
  const size_t row = (size_t)3 * H * VR;  // vectors of a token's qkv row
  const uint4* src = x + ((size_t)b * N + n0) * row + (size_t)sh * VR;
  const uint4* bsrc = bias + (size_t)sh * VR;
  uint4* dst = out + ((((size_t)s * B + b) * H + h) * N + n0) * VR;
  const int tokens = min(kTokens, N - n0);
  const bool turn = ROPE && s < 2;
  // float4s of one of the table's halves, and of one token's row in it
  const size_t half = (size_t)(N - 1) * VR * kQ;

  uint4 a[kPer], c[kPer];
  float4 cs[ROPE ? kPer : 1][kQ], sn[ROPE ? kPer : 1][kQ];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int n = i / VR;
    const int v = i - n * VR;
    if (n < tokens) {
      a[j] = __ldcs(src + n * row + v);
      c[j] = __ldg(bsrc + v);
      if constexpr (ROPE) {
        if (turn && n0 + n > 0) {
          const float4* t = rope + ((size_t)(n0 + n - 1) * VR + v) * kQ;
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            cs[j][q] = __ldg(t + q);
            sn[j][q] = __ldg(t + half + q);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int n = i / VR;
    if (n < tokens) {
      uint4 r = add16<E>(a[j], c[j]);
      if constexpr (ROPE) {
        if (turn && n0 + n > 0) r = rotate16<E>(r, cs[j], sn[j]);
      }
      dst[i] = r;
    }
  }
}

template <int E, int VR>
int launch_vr(const void* x, const void* bias, const void* rope, void* out,
              int B, int N, int H, cudaStream_t stream) {
  const dim3 grid((N + kTokens - 1) / kTokens, 3 * H, B);
  if (rope == nullptr)
    qkv_heads_kernel<E, VR, false><<<grid, kThreads, 0, stream>>>(
        (const uint4*)x, (const uint4*)bias, nullptr, (uint4*)out, B, N, H);
  else
    qkv_heads_kernel<E, VR, true><<<grid, kThreads, 0, stream>>>(
        (const uint4*)x, (const uint4*)bias, (const float4*)rope,
        (uint4*)out, B, N, H);
  return (int)cudaGetLastError();
}

bool misaligned(const void* p) { return ((uintptr_t)p & 15) != 0; }

// E elements of T a 16-byte vector; rope null: no rotation
template <int E>
int launch(const void* x, const void* bias, const void* rope, void* out,
           int B, int N, int H, int D, void* stream) {
  if (B < 1 || N < 1 || H < 1 || B > 65535 || 3 * H > 65535 ||
      x == nullptr || bias == nullptr || out == nullptr || misaligned(x) ||
      misaligned(bias) || misaligned(out) || misaligned(rope))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 32) return launch_vr<E, 32 / E>(x, bias, rope, out, B, N, H, s);
  if (D == 64) return launch_vr<E, 64 / E>(x, bias, rope, out, B, N, H, s);
  if (D == 80) return launch_vr<E, 80 / E>(x, bias, rope, out, B, N, H, s);
  if (D == 72) return launch_vr<E, 72 / E>(x, bias, rope, out, B, N, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: the qkv product [B, N, 3 H D] before its bias; bias: [3 H D]; out:
// [3, B, H, N, D]; all contiguous, of the entry point's type, 16-byte
// aligned, on the device. D (the head dim): 32, 64, 72 or 80; any other
// returns cudaErrorInvalidValue. Returns a cudaError_t (0 on success).
extern "C" int excel_qkv_heads_bf16(const void* x, const void* bias,
                                    void* out, int B, int N, int H, int D,
                                    void* stream) {
  return launch<8>(x, bias, nullptr, out, B, N, H, D, stream);
}

extern "C" int excel_qkv_heads_f32(const void* x, const void* bias, void* out,
                                   int B, int N, int H, int D, void* stream) {
  return launch<4>(x, bias, nullptr, out, B, N, H, D, stream);
}

// The same, q and k turned at tokens 1..N-1 by rope: fp32 [2, N-1, D]
// (cos, then sin), contiguous, 16-byte aligned, on the device.
extern "C" int excel_qkv_heads_rope_bf16(const void* x, const void* bias,
                                         const void* rope, void* out, int B,
                                         int N, int H, int D, void* stream) {
  if (rope == nullptr || N < 2) return (int)cudaErrorInvalidValue;
  return launch<8>(x, bias, rope, out, B, N, H, D, stream);
}

extern "C" int excel_qkv_heads_rope_f32(const void* x, const void* bias,
                                        const void* rope, void* out, int B,
                                        int N, int H, int D, void* stream) {
  if (rope == nullptr || N < 2) return (int)cudaErrorInvalidValue;
  return launch<4>(x, bias, rope, out, B, N, H, D, stream);
}
