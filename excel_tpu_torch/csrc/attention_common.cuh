// Shared pieces of the attention kernels (attention_plain.cu,
// attention_surgery.cu), for fp32 and bf16 q/k/v.
//
// One block owns TQ query rows of one image. The [TQ, N] logits of one head
// live in shared memory (a 401-token f32 row is 1.6 KB); keys and values
// are staged through shared memory in chunks of kTK rows, as fp32 whatever
// the element type T of q/k/v. Products run as CUDA-core FMA in fp32 (no
// TF32). With bf16 inputs every product of two bf16 values is exact in
// fp32, so the logits are the fp32-accumulated dot products the TPU's
// `preferred_element_type=float32` asks for; softmax stays fp32, P is
// rounded to bf16 before P V (the TPU kernels' `attn.astype(v.dtype)`) and
// the context is stored as bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace excel {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTX = 16;        // threads along keys / head dim
constexpr int kTY = 16;        // threads along query rows
constexpr int kTK = 64;        // keys per staged chunk (4 per thread)

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Row stride of a [TQ, N] f32 buffer: a whole number of key chunks plus 16
// floats, so the two query rows one warp touches sit 16 banks apart.
__host__ __device__ inline int row_stride(int n) {
  return round_up(n, kTK) + 16;
}

// Row stride of a staged [rows, D] tile: 16-byte aligned rows for float4
// reads along d; D + 4 floats puts the rows of 8 consecutive keys on
// disjoint banks (D + 4 = 4 mod 32 for D = 32, 64).
template <int D>
__host__ __device__ constexpr int tile_stride() {
  return D + 4;
}

// p as the P V product sees it: unchanged for fp32, rounded to bf16 for bf16.
__device__ inline float round_p(float p, const float*) { return p; }
__device__ inline float round_p(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// Stage rows [r0, r0 + rows) of a row-major [n, D] matrix into shared memory
// (row stride tile_stride<D>()) as fp32, 16 bytes per thread and load (four
// floats or eight bf16); rows past n are zero.
template <int D>
__device__ inline void stage_rows(float* dst, const float* src, int r0,
                                  int rows, int n) {
  constexpr int V = D / 4;
  for (int i = threadIdx.x; i < rows * V; i += kThreads) {
    const int r = i / V;
    const int c = i - r * V;
    const int g = r0 + r;
    const float4 x = g < n
        ? reinterpret_cast<const float4*>(src + (size_t)g * D)[c]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(dst + r * tile_stride<D>())[c] = x;
  }
}

template <int D>
__device__ inline void stage_rows(float* dst, const __nv_bfloat16* src,
                                  int r0, int rows, int n) {
  constexpr int V = D / 8;
  for (int i = threadIdx.x; i < rows * V; i += kThreads) {
    const int r = i / V;
    const int c = i - r * V;
    const int g = r0 + r;
    float f[8];
    if (g < n) {
      const uint4 x = reinterpret_cast<const uint4*>(src + (size_t)g * D)[c];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 t = __bfloat1622float2(h[j]);
        f[2 * j] = t.x;
        f[2 * j + 1] = t.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * tile_stride<D>() + c * 8);
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

__device__ inline float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// S[r, j] = scale * <A_r, B_j> for the TQ staged rows A against all n rows
// of the global [n, D] matrix Bg; -inf for padded keys j >= n, so a
// softmax over the padded row gives them weight 0. Each thread holds a
// (TQ/16) x 4 tile of the product and reads A and B as float4 along d.
template <int D, int TQ, typename T>
__device__ void logits_rows(float* S, int stride, const float* As, float* Bs,
                            const T* Bg, int n, float scale) {
  constexpr int RT = TQ / kTY;
  constexpr int TS = tile_stride<D>();
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int n_pad = round_up(n, kTK);
  for (int c0 = 0; c0 < n_pad; c0 += kTK) {
    __syncthreads();  // earlier readers of Bs are done; As is visible
    stage_rows<D>(Bs, Bg, c0, kTK, n);
    __syncthreads();
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[RT], b[4];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + kTY * i) * TS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bs + (tx + kTX * j) * TS + d);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = c0 + tx + kTX * j;
        S[(ty + kTY * i) * stride + key] =
            key < n ? acc[i][j] * scale : -INFINITY;
      }
  }
  __syncthreads();
}

// Row softmax of the TQ rows of S over their n_pad (= padded) columns:
// exp(x - max) / sum, one warp per row. The final pass hands each
// probability p of a real column (j < n) to epi(r, j, p) and, with kStore,
// writes it back into S as P V will use it (round_p for element type T;
// padded columns hold 0 either way). Every call maps a given (r, j) to the
// same thread, so an epilogue that updates its own elements of device
// memory needs no synchronisation.
template <int TQ, bool kStore, typename T, typename Epi>
__device__ void softmax_rows(float* S, int stride, int n, Epi epi) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_pad = round_up(n, kTK);
  for (int r = warp; r < TQ; r += kThreads / 32) {
    float* row = S + r * stride;
    float m = -INFINITY;
    for (int j = lane; j < n_pad; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
    for (int j = lane; j < n_pad; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    for (int j = lane; j < n; j += 32) {
      const float p = row[j] / s;
      if (kStore) row[j] = round_p(p, (const T*)nullptr);
      epi(r, j, p);
    }
  }
  __syncthreads();
}

// Columns [tx * CT, tx * CT + CT) of row j of a staged V tile.
template <int CT>
struct VecCols;
template <>
struct VecCols<4> {
  __device__ static void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    __nv_bfloat162 x[2] = {__floats2bfloat162_rn(v[0], v[1]),
                           __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(x);
  }
};
template <>
struct VecCols<2> {
  __device__ static void load(const float* p, float* v) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};

// out[r0 + r, :] = P[r, :] @ V for the block's TQ rows (rows < n written,
// rounded to T);
// V is the global [n, D] value matrix of one (image, head), staged through
// Vs in chunks. P's padded columns are 0 and padded V rows are staged as 0.
// Each thread holds rows ty + 16 i and the D/16 consecutive columns from
// tx * D/16, reading P as float4 along keys and V as vectors along d.
template <int D, int TQ, typename T>
__device__ void pv_rows(T* out, int r0, int n, const float* P, int stride,
                        float* Vs, const T* Vg) {
  constexpr int RT = TQ / kTY;
  constexpr int CT = D / kTX;
  constexpr int TS = tile_stride<D>();
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[i][c] = 0.f;
  const int n_pad = round_up(n, kTK);
  for (int c0 = 0; c0 < n_pad; c0 += kTK) {
    __syncthreads();
    stage_rows<D>(Vs, Vg, c0, kTK, n);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTK; j += 4) {
      float4 p[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        p[i] = *reinterpret_cast<const float4*>(
            P + (ty + kTY * i) * stride + c0 + j);
      float v[4][CT];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        VecCols<CT>::load(Vs + (j + u) * TS + tx * CT, v[u]);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          acc[i][c] = fmaf(p[i].x, v[0][c], acc[i][c]);
          acc[i][c] = fmaf(p[i].y, v[1][c], acc[i][c]);
          acc[i][c] = fmaf(p[i].z, v[2][c], acc[i][c]);
          acc[i][c] = fmaf(p[i].w, v[3][c], acc[i][c]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int g = r0 + ty + kTY * i;
    if (g < n) VecCols<CT>::store(out + (size_t)g * D + tx * CT, acc[i]);
  }
  __syncthreads();
}

// Largest query tile (32 or 16 rows) whose shared memory (one [TQ, N] row
// buffer, the staged query rows and one key chunk) fits the device's opt-in
// limit; 0 if none fits.
inline int pick_tile(int n, int d, size_t* smem_out) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int tiles[2] = {32, 16};
  for (int tq : tiles) {
    const size_t smem =
        sizeof(float) * ((size_t)tq * row_stride(n) +
                         (size_t)(tq + kTK) * (d + 4));
    if (smem <= (size_t)limit) {
      *smem_out = smem;
      return tq;
    }
  }
  return 0;
}

}  // namespace excel
