// Exact-fp32 attention on the CUDA cores: the two kernels behind the fp32
// entry points of attention_plain.cu and attention_surgery.cu (the parity
// route: FFMA only, no TF32, no bf16 splitting). attention_common.cuh says
// what the two kernels do; this file is their fp32 arithmetic.
//
// What bounds them: fp32 FMA throughput. A (16 RT) x 64 x D tile product is
// spread over the block's 128 threads as RT rows x 8 keys each, read from
// shared memory as float4 along d: with RT = 4, 12 loads of 16 bytes feed
// 128 FMA, with RT = 8, 16 feed 256. The price of keeping no row buffer is
// arithmetic: surgery forms 10 products of 2 N^2 D a head where 5 are the
// minimum (4 + 2 in the rows kernel, 4 in the sums kernel), plain attention
// 3 instead of 2 (4 with weights); every instruction that is not an FMA
// (the softmax's maximum, exponent and sum, the loads) takes an instruction
// slot from them.
//
// Thread (tx = tid % 8, ty = tid / 8) of a block holds rows RT ty + i and
// keys tx + 8 j of a tile; the 8 lanes that share a row are neighbours in a
// warp, so row statistics combine by shuffles, and P goes from the logits'
// layout to the P V product's through a shared-memory tile (written in one
// step, read in the next). Tiles are [rows][D + 4] floats: the padding puts
// the 8 rows that 8 lanes read together on 8 different bank groups.
//
// Steps run through one two-stage `cp.async` ring of single 64-row tiles.
// The rows kernel streams the chunks of one matrix against one row tile at
// a time, one softmax's statistics a phase: k k^T, v v^T, q q^T, q k^T
// (plain: q k^T only), each written to the scratch when its phase ends; then
// pass 2 alternates a chunk of K (logits, P) and of V (P V). The row tile
// changes at three phase starts (a blocking copy). The sums kernel takes
// one (row tile, key tile) pair a product and head, and one launch a head
// sum: softmax(q k^T) and the mix share no product, so two launches form
// no logit twice and each keeps one accumulator tile in registers.
#pragma once

#include "attention_common.cuh"

namespace excel {
namespace fma {

template <int D>
__host__ __device__ constexpr int stride() {
  return D + 4;
}
constexpr int kPS = kTile + 4;  // row stride of a P tile

// `rows` rows from r0 of the row-major [n, D] matrix src into the tile dst
// (row stride D + 4); rows >= n are zero. Starts cp.async copies only.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int rows, int n) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C;
    const int c = i % C;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * stride<D>() + c * 4,
               src + (size_t)(ok ? r0 + r : 0) * D + c * 4, ok);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// S[i][j] = <A row RT ty + i, B row tx + 8 j>, raw fp32 sums over d in order.
template <int D, int RT>
__device__ __forceinline__ void tile_logits(float (&S)[RT][8], const float* At,
                                            const float* Bt) {
  constexpr int TS = stride<D>();
  const float* a0 = At + (threadIdx.x >> 3) * RT * TS;
  const float* b0 = Bt + (threadIdx.x & 7) * TS;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) S[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      a[i] = *reinterpret_cast<const float4*>(a0 + i * TS + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(b0 + 8 * j * TS + d);
#pragma unroll
      for (int i = 0; i < RT; ++i) S[i][j] = dot4(a[i], b, S[i][j]);
    }
  }
}

// Keys >= n of the chunk starting at key c0 to -inf.
template <int RT>
__device__ __forceinline__ void mask_keys(float (&S)[RT][8], int c0, int n) {
  const int tx = threadIdx.x & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (c0 + tx + 8 * j >= n) {
#pragma unroll
      for (int i = 0; i < RT; ++i) S[i][j] = -INFINITY;
    }
}

// Running softmax statistics of a thread's own columns of its RT rows.
template <int RT>
struct RowStat {
  float m[RT];
  float s[RT];
};

template <int RT>
__device__ __forceinline__ void stat_init(RowStat<RT>& st) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    st.m[i] = -INFINITY;
    st.s[i] = 0.f;
  }
}

template <int RT>
__device__ __forceinline__ void stat_update(RowStat<RT>& st,
                                            const float (&S)[RT][8], float c) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float mx = st.m[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, S[i][j]);
    const float mc = stat_rescale(st.m[i], st.s[i], mx, c);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += exp2f(fmaf(S[i][j], c, -mc));
    st.s[i] += sum;
  }
}

// ---------------------------------------------------------------------------
// rows_kernel: ctx = softmax(q k^T) v and the row statistics
// ---------------------------------------------------------------------------

// Grid (row tiles of 16 RT rows, H, B). Shared memory: the row tile, two
// ring stages of one 64-row tile, the P tile. stats may be null (plain, no
// weights).
template <int D, int RT, bool kSurgery>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ ctx,
                float* __restrict__ stats, int H, int N, float c) {
  extern __shared__ __align__(16) float smem_f32[];
  constexpr int TS = stride<D>();
  constexpr int T = kTile * TS;
  constexpr int ROWS = 16 * RT;
  constexpr int P = kSurgery ? 4 : 1;
  constexpr int NG = D / 32;  // groups of 4 context columns a thread
  float* At = smem_f32;       // [ROWS][TS]
  float* ring = At + ROWS * TS;  // [2][64][TS]
  float* Ps = ring + 2 * T;      // [ROWS][kPS]

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int r0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * N * D;
  const float* qg = q + base;
  const float* kg = k + base;
  const float* vg = v + base;
  const int nc = (N + kTile - 1) / kTile;
  const int stat_steps = P * nc;
  const int steps = stat_steps + 2 * nc;

  // Statistics phases in this order, so that the row tile changes least:
  // surgery k k^T, v v^T, q q^T, q k^T; plain q k^T. Pass 2 keeps the q
  // rows and the q k^T statistics.
  auto prefetch = [&](int step) {
    float* st = ring + (step & 1) * T;
    if (step < stat_steps) {
      const int ph = step / nc;
      const int c0 = (step - ph * nc) * kTile;
      const float* src = kg;
      if constexpr (kSurgery) src = ph == 1 ? vg : (ph == 2 ? qg : kg);
      load_tile<D>(st, src, c0, kTile, N);
    } else {
      const int u = step - stat_steps;
      load_tile<D>(st, (u & 1) ? vg : kg, (u >> 1) * kTile, kTile, N);
    }
    cp_async_commit();
  };

  RowStat<RT> st;
  stat_init(st);
  float O[RT][NG * 4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int x = 0; x < NG * 4; ++x) O[i][x] = 0.f;

  prefetch(0);
  for (int step = 0; step < steps; ++step) {
    // a new row tile at the start of a phase whose rows change: every warp
    // is past the barrier that ended the last step that read the old one
    if (step == 0 || (kSurgery && (step == nc || step == 2 * nc))) {
      const float* src = qg;
      if constexpr (kSurgery) src = step == 0 ? kg : (step == nc ? vg : qg);
      load_tile<D>(At, src, r0, ROWS, N);
      cp_async_commit();
    }
    if (step + 1 < steps) prefetch(step + 1);
    cp_async_wait_step(step + 1 < steps);
    __syncthreads();
    const float* Bt = ring + (step & 1) * T;
    if (step < stat_steps) {
      const int ph = step / nc;
      const int c0 = (step - ph * nc) * kTile;
      float S[RT][8];
      tile_logits<D, RT>(S, At, Bt);
      if (c0 + kTile > N) mask_keys<RT>(S, c0, N);
      stat_update<RT>(st, S, c);
      if (c0 + kTile >= N) {
        // the phase's last chunk: (m c, 1 / s) of its softmax, statistics
        // index 0 q k^T, 1 q q^T, 2 k k^T, 3 v v^T
#pragma unroll
        for (int i = 0; i < RT; ++i) stat_combine<8>(st.m[i], st.s[i], c);
        if (stats != nullptr && tx == 0) {
          const int p = kSurgery ? (ph == 0 ? 2 : (ph == 1 ? 3 : 3 - ph)) : 0;
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const int row = r0 + ty * RT + i;
            if (row < N)
              reinterpret_cast<float2*>(
                  stats + (((size_t)b * H + h) * N + row) * (2 * P))[p] =
                  make_float2(st.m[i], st.s[i]);
          }
        }
        if (step + 1 < stat_steps) stat_init(st);
      }
    } else {
      const int u = step - stat_steps;
      if ((u & 1) == 0) {
        // a chunk of K: the normalised p into the P tile
        const int c0 = (u >> 1) * kTile;
        float S[RT][8];
        tile_logits<D, RT>(S, At, Bt);
        if (c0 + kTile > N) mask_keys<RT>(S, c0, N);
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            Ps[(ty * RT + i) * kPS + tx + 8 * j] =
                exp2f(fmaf(S[i][j], c, -st.m[i])) * st.s[i];
      } else {
        // the same chunk of V: O += P V, columns 32 g + 4 tx + (0..3)
#pragma unroll 2
        for (int key = 0; key < kTile; key += 4) {
          float pa[RT][4];
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(
                Ps + (ty * RT + i) * kPS + key);
            pa[i][0] = x.x; pa[i][1] = x.y; pa[i][2] = x.z; pa[i][3] = x.w;
          }
#pragma unroll
          for (int u4 = 0; u4 < 4; ++u4)
#pragma unroll
            for (int g = 0; g < NG; ++g) {
              const float4 x = *reinterpret_cast<const float4*>(
                  Bt + (key + u4) * TS + g * 32 + tx * 4);
#pragma unroll
              for (int i = 0; i < RT; ++i) {
                O[i][g * 4 + 0] = fmaf(pa[i][u4], x.x, O[i][g * 4 + 0]);
                O[i][g * 4 + 1] = fmaf(pa[i][u4], x.y, O[i][g * 4 + 1]);
                O[i][g * 4 + 2] = fmaf(pa[i][u4], x.z, O[i][g * 4 + 2]);
                O[i][g * 4 + 3] = fmaf(pa[i][u4], x.w, O[i][g * 4 + 3]);
              }
            }
        }
      }
    }
    // the ring stage, the row tile and the P tile are free again
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = r0 + ty * RT + i;
    if (row >= N) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      *reinterpret_cast<float4*>(ctx + base + (size_t)row * D + g * 32 +
                                 tx * 4) =
          make_float4(O[i][g * 4], O[i][g * 4 + 1], O[i][g * 4 + 2],
                      O[i][g * 4 + 3]);
  }
}

// ---------------------------------------------------------------------------
// sums_kernel: one [N, N] head sum, a (16 RT) x 64 patch a block
// ---------------------------------------------------------------------------

// Grid (key tiles, row tiles, B). kMix false: out = sum_h softmax(q k^T)
// x out_scale (mode 2 adds the values already in out); kMix true: out =
// sum_h (softmax(q q^T) + softmax(k k^T) + softmax(v v^T)) / 3 + H ex.
// A step is one product of one head: a stage holds its row tile and its
// key tile. stats holds P pairs a row (4 for surgery, 1 for plain).
template <int D, int RT, bool kMix>
__global__ void __launch_bounds__(kThreads)
    sums_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ stats,
                const float* __restrict__ ex, float* out, int H, int N, int P,
                int mode, float c, float out_scale) {
  extern __shared__ __align__(16) float smem_f32[];
  constexpr int TS = stride<D>();
  constexpr int ROWS = 16 * RT;
  constexpr int STAGE = (ROWS + kTile) * TS;
  constexpr int NP = kMix ? 3 : 1;  // products a head
  constexpr int P0 = kMix ? 1 : 0;  // first statistics index

  const int tx = threadIdx.x & 7;
  const int ty = threadIdx.x >> 3;
  const int k0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * ROWS;
  const int b = blockIdx.z;
  const int steps = H * NP;

  // product p (statistics index): 0 q k^T, 1 q q^T, 2 k k^T, 3 v v^T
  auto prefetch = [&](int step) {
    float* st = smem_f32 + (step & 1) * STAGE;
    const int h = step / NP;
    const int p = P0 + step - h * NP;
    const size_t base = ((size_t)b * H + h) * N * D;
    load_tile<D>(st, (p < 2 ? q : (p == 2 ? k : v)) + base, r0, ROWS, N);
    load_tile<D>(st + ROWS * TS, (p == 1 ? q : (p == 3 ? v : k)) + base, k0,
                 kTile, N);
    cp_async_commit();
  };

  float acc[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  prefetch(0);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) prefetch(step + 1);
    const int h = step / NP;
    const int p = P0 + step - h * NP;
    // the rows' statistics of this product, loaded while the copies land;
    // rows >= N take (0, 0): p = 0
    float mc[RT], w[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = r0 + ty * RT + i;
      const float2 x =
          row < N ? __ldg(reinterpret_cast<const float2*>(
                        stats + (((size_t)b * H + h) * N + row) * (2 * P)) +
                          p)
                  : make_float2(0.f, 0.f);
      mc[i] = x.x;
      w[i] = kMix ? x.y * (1.f / 3.f) : x.y;
    }
    cp_async_wait_step(step + 1 < steps);
    __syncthreads();
    const float* st = smem_f32 + (step & 1) * STAGE;
    float S[RT][8];
    tile_logits<D, RT>(S, st, st + ROWS * TS);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = fmaf(exp2f(fmaf(S[i][j], c, -mc[i])), w[i], acc[i][j]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = r0 + ty * RT + i;
      const int key = k0 + tx + 8 * j;
      if (row >= N || key >= N) continue;
      const size_t e = ((size_t)b * N + row) * N + key;
      if constexpr (kMix) {
        out[e] = ex != nullptr ? fmaf((float)H, ex[e], acc[i][j]) : acc[i][j];
      } else {
        // a product rounded on its own: mode acc == mode out + the
        // accumulator bit for bit (no contraction into an FMA)
        const float x = __fmul_rn(acc[i][j], out_scale);
        out[e] = mode == 2 ? out[e] + x : x;
      }
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Rows a thread (16 RT rows a block). 8 feeds 256 FMA from 16 shared-memory
// loads where 4 feeds 128 from 12, and measured 10% faster at N = 577 and
// 901 (B=8, H=12, on an H100); but 128-row tiles pad N = 401 to 512 rows where 64-row tiles pad it
// to 448, and need enough blocks: 8 only when the padding costs under 7%
// and the grid still gives every SM three blocks.
inline int pick_rt(int blocks_per_row_tile, int N) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles8 = (N + 127) / 128;
  const int tiles4 = (N + 63) / 64;
  return tiles8 * 128 * 100 <= tiles4 * 64 * 107 &&
                 tiles8 * blocks_per_row_tile >= 3 * sms
             ? 8
             : 4;
}

template <int D, int RT, bool kSurgery>
cudaError_t launch_rows_rt(const float* q, const float* k, const float* v,
                           float* ctx, float* stats, int B, int H, int N,
                           cudaStream_t stream) {
  auto kern = rows_kernel<D, RT, kSurgery>;
  const size_t smem = sizeof(float) * (16 * RT * (stride<D>() + kPS) +
                                       2 * kTile * stride<D>());
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + 16 * RT - 1) / (16 * RT), H, B);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, ctx, stats, H, N,
                                         scale_log2e(D));
  return cudaGetLastError();
}

template <int D, bool kSurgery>
cudaError_t launch_rows(const float* q, const float* k, const float* v,
                        float* ctx, float* stats, int B, int H, int N,
                        cudaStream_t stream) {
  return pick_rt(H * B, N) == 8
             ? launch_rows_rt<D, 8, kSurgery>(q, k, v, ctx, stats, B, H, N,
                                              stream)
             : launch_rows_rt<D, 4, kSurgery>(q, k, v, ctx, stats, B, H, N,
                                              stream);
}

template <int D, int RT, bool kMix>
cudaError_t launch_sum_rt(const float* q, const float* k, const float* v,
                          const float* stats, const float* ex, float* out,
                          int B, int H, int N, int P, int mode,
                          float out_scale, cudaStream_t stream) {
  auto kern = sums_kernel<D, RT, kMix>;
  const size_t smem = sizeof(float) * 2 * (16 * RT + kTile) * stride<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nt = (N + kTile - 1) / kTile;
  dim3 grid(nt, (N + 16 * RT - 1) / (16 * RT), B);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, stats, ex, out, H, N, P,
                                         mode, scale_log2e(D), out_scale);
  return cudaGetLastError();
}

// One launch a head sum: attn (kAttn) and mix (kMix) are separate products
// with separate tiles, so two launches form no logit twice.
template <int D, bool kAttn, bool kMix>
cudaError_t launch_sums(const float* q, const float* k, const float* v,
                        const float* stats, const float* ex, float* mix,
                        float* attn, int B, int H, int N, int mode,
                        float out_scale, cudaStream_t stream) {
  const int nt = (N + kTile - 1) / kTile;
  const bool rt8 = pick_rt(nt * B, N) == 8;
  const int P = kMix ? 4 : 1;
  if (kAttn) {
    cudaError_t err =
        rt8 ? launch_sum_rt<D, 8, false>(q, k, v, stats, nullptr, attn, B, H,
                                         N, P, mode, out_scale, stream)
            : launch_sum_rt<D, 4, false>(q, k, v, stats, nullptr, attn, B, H,
                                         N, P, mode, out_scale, stream);
    if (err != cudaSuccess || !kMix) return err;
  }
  return rt8 ? launch_sum_rt<D, 8, true>(q, k, v, stats, ex, mix, B, H, N, P,
                                         mode, out_scale, stream)
             : launch_sum_rt<D, 4, true>(q, k, v, stats, ex, mix, B, H, N, P,
                                         mode, out_scale, stream);
}

}  // namespace fma
}  // namespace excel
