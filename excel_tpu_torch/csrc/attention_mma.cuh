// Tensor-core attention for bf16 q/k/v: the two kernels behind the bf16
// entry points of attention_plain.cu and attention_surgery.cu.
// attention_common.cuh says what the two kernels do; this file is their
// bf16 arithmetic.
//
// What bounds them: not the products any more. Every product (q k^T, q q^T,
// k k^T, v v^T, P V) is `mma.sync.m16n8k16` on bf16 tiles with fp32 sums
// (a product of two bf16 values is exact in fp32), so they cost less than
// the exponentials of the softmaxes (one MUFU ex2 a logit and pass, 16 a
// clock and SM: 9 a logit and head for surgery, 2 for plain attention) and
// the L2 reads of the key tiles; the [B, N, N] head sums reach device memory
// once. No fp32 copy of q, k or v is ever staged.
//
// A warp owns 16 of the block's 64 rows. Its logits stay in the accumulator
// fragments (a row's columns lie in the four lanes of a quad: row maximum
// and sum combine by two shuffles, once a softmax); pass 2 rounds the
// normalised p to bf16 in those registers, which are exactly the A fragments
// of P V, so P never touches shared memory. K tiles feed q k^T as the `col`
// operand as they lie ([key][d] row-major); V feeds P V through
// `ldmatrix.trans`. Tiles are [64][D] bf16 with the 16-byte chunks of a row
// XOR-swizzled by the row, so `ldmatrix` reads 8 rows without a bank
// conflict and without padding.
//
// The rows kernel's ring stage holds the chunk's K, V (and Q for surgery);
// the sums kernel's holds one head's tiles (q rows and k keys; for the mix
// also k rows, v rows, q keys, v keys) and keeps both head sums of its
// 64 x 64 patch in registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace excel {
namespace tc {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

// Element offset of the 16-byte chunk c of row r in a swizzled [64][D] tile:
// 8 consecutive rows at one c land on 8 different bank groups.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return D == 64 ? r * 64 + ((c ^ (r & 7)) << 3)
                 : r * 32 + ((c ^ ((r >> 1) & 3)) << 3);
}

// Rows [r0, r0 + 64) of the row-major [n, D] matrix src into the tile dst;
// rows >= n are zero. Starts cp.async copies only: commit and wait are the
// caller's.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int n) {
  constexpr int C = D / 8;
#pragma unroll
  for (int it = 0; it < kTile * C / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / C;
    const int c = i % C;
    const bool ok = r0 + r < n;
    cp_async16(dst + swz<D>(r, c),
               src + (size_t)(ok ? r0 + r : 0) * D + c * 8, ok);
  }
}

// A fragments (all D/16 k-steps) of rows [row0, row0 + 16) of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4],
                                       const bf16* tile, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm4(a[ks], tile + swz<D>(row0 + (lane & 15), 2 * ks + (lane >> 4)));
}

// S[j][.] = A (16 rows) . B^T for the 64 rows of the tile Bt, raw fp32 sums;
// S[j] is the accumulator fragment of keys [8 j, 8 j + 8): a thread (g =
// lane / 4, t = lane % 4) holds rows g (elements 0, 1) and g + 8 (2, 3) at
// keys 8 j + 2 t and + 1.
template <int D>
__device__ __forceinline__ void warp_logits(float (&S)[8][4],
                                            const uint32_t (&a)[D / 16][4],
                                            const bf16* Bt) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = 0.f;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    const int key = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t b[4];
      ldsm4(b, Bt + swz<D>(key, 2 * ks + ((lane >> 3) & 1)));
      mma16816(S[2 * jp], a[ks], b[0], b[1]);
      mma16816(S[2 * jp + 1], a[ks], b[2], b[3]);
    }
  }
}

// Keys >= n of the chunk starting at key c0 to -inf.
__device__ __forceinline__ void mask_keys(float (&S)[8][4], int c0, int n) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + j * 8 + 2 * t + (e & 1) >= n) S[j][e] = -INFINITY;
}

// Running softmax statistics of a thread's own columns of rows g and g + 8:
// the maximum of the raw logits and sum 2^((x - m) c).
struct RowStat {
  float m[2];
  float s[2];
};

__device__ __forceinline__ void stat_init(RowStat& st) {
  st.m[0] = st.m[1] = -INFINITY;
  st.s[0] = st.s[1] = 0.f;
}

__device__ __forceinline__ void stat_update(RowStat& st,
                                            const float (&S)[8][4], float c) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = st.m[i];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(S[j][2 * i], S[j][2 * i + 1]));
    const float mc = stat_rescale(st.m[i], st.s[i], mx, c);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sum += exp2f(fmaf(S[j][2 * i], c, -mc)) +
             exp2f(fmaf(S[j][2 * i + 1], c, -mc));
    st.s[i] += sum;
  }
}

// The four threads of a quad hold the columns of one row.
__device__ __forceinline__ void stat_finish(RowStat& st, float c) {
  stat_combine<4>(st.m[0], st.s[0], c);
  stat_combine<4>(st.m[1], st.s[1], c);
}

// ---------------------------------------------------------------------------
// rows_kernel: ctx = softmax(q k^T) v and the row statistics
// ---------------------------------------------------------------------------

// Grid (row tiles, H, B). kSurgery: statistics of the four softmaxes (the
// k k^T and v v^T rows use rows of k and v as their queries), else of
// softmax(q k^T) alone. stats may be null (no head sums wanted; plain only).
// Shared memory: 1 (or 3) row tiles, then two stages of 2 (or 3) key tiles.
template <int D, bool kSurgery>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ ctx,
                float* __restrict__ stats, int H, int N, float c) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int T = kTile * D;
  constexpr int NA = kSurgery ? 3 : 1;  // row tiles: q (, k, v)
  constexpr int NB = kSurgery ? 3 : 2;  // a stage: K, V (, Q)
  constexpr int P = kSurgery ? 4 : 1;
  bf16* At = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = At + NA * T;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = ((size_t)b * H + h) * N * D;
  const bf16* qg = q + base;
  const bf16* kg = k + base;
  const bf16* vg = v + base;
  const int nc = (N + kTile - 1) / kTile;
  const int steps = 2 * nc;  // pass 1 over the chunks, then pass 2

  auto prefetch = [&](int step) {
    bf16* st = ring + (step & 1) * NB * T;
    const bool pass1 = step < nc;
    const int c0 = (pass1 ? step : step - nc) * kTile;
    load_tile<D>(st, kg, c0, N);
    if (kSurgery || !pass1) load_tile<D>(st + T, vg, c0, N);
    if constexpr (kSurgery) {
      if (pass1) load_tile<D>(st + 2 * T, qg, c0, N);
    }
    cp_async_commit();
  };

  load_tile<D>(At, qg, r0, N);
  if constexpr (kSurgery) {
    load_tile<D>(At + T, kg, r0, N);
    load_tile<D>(At + 2 * T, vg, r0, N);
  }
  prefetch(0);

  uint32_t aq[D / 16][4];
  RowStat st[P];
#pragma unroll
  for (int p = 0; p < P; ++p) stat_init(st[p]);
  float O[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[j][e] = 0.f;

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) prefetch(step + 1);
    cp_async_wait_step(step + 1 < steps);
    __syncthreads();
    if (step == 0) load_a<D>(aq, At, warp * 16);
    const bf16* stg = ring + (step & 1) * NB * T;
    const bool pass1 = step < nc;
    const int c0 = (pass1 ? step : step - nc) * kTile;
    const bool ragged = c0 + kTile > N;
    float S[8][4];
    warp_logits<D>(S, aq, stg);
    if (ragged) mask_keys(S, c0, N);
    if (pass1) {
      stat_update(st[0], S, c);
      if constexpr (kSurgery) {
        warp_logits<D>(S, aq, stg + 2 * T);
        if (ragged) mask_keys(S, c0, N);
        stat_update(st[1], S, c);
        uint32_t a2[D / 16][4];
        load_a<D>(a2, At + T, warp * 16);
        warp_logits<D>(S, a2, stg);
        if (ragged) mask_keys(S, c0, N);
        stat_update(st[2], S, c);
        load_a<D>(a2, At + 2 * T, warp * 16);
        warp_logits<D>(S, a2, stg + T);
        if (ragged) mask_keys(S, c0, N);
        stat_update(st[3], S, c);
      }
      if (step == nc - 1) {
#pragma unroll
        for (int p = 0; p < P; ++p) stat_finish(st[p], c);
      }
    } else {
      // the normalised p, rounded to bf16, as the A operand of P V
      const bf16* Vt = stg + T;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float(&s)[4] = S[2 * kk + u];
          pa[2 * u] = pack_bf16(
              exp2f(fmaf(s[0], c, -st[0].m[0])) * st[0].s[0],
              exp2f(fmaf(s[1], c, -st[0].m[0])) * st[0].s[0]);
          pa[2 * u + 1] = pack_bf16(
              exp2f(fmaf(s[2], c, -st[0].m[1])) * st[0].s[1],
              exp2f(fmaf(s[3], c, -st[0].m[1])) * st[0].s[1]);
        }
        const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          ldsm4_trans(bv, Vt + swz<D>(key, 2 * dp + (lane >> 4)));
          mma16816(O[2 * dp], pa, bv[0], bv[1]);
          mma16816(O[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + warp * 16 + g + 8 * i;
    if (row >= N) continue;
    bf16* out = ctx + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(O[j][2 * i], O[j][2 * i + 1]);
    if (stats != nullptr && t == 0) {
      float2* srow = reinterpret_cast<float2*>(
          stats + (((size_t)b * H + h) * N + row) * (2 * P));
#pragma unroll
      for (int p = 0; p < P; ++p)
        srow[p] = make_float2(st[p].m[i], st[p].s[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// sums_kernel: the [N, N] head sums, one 64 x 64 patch a block
// ---------------------------------------------------------------------------

// Grid (key tiles, row tiles, B). kAttn: attn = sum_h softmax(q k^T)
// (x out_scale; mode 2 adds the values already in attn). kMix: mix = sum_h
// (softmax(q q^T) + softmax(k k^T) + softmax(v v^T)) / 3 + H ex. A stage
// holds the head's tiles: q rows, k keys (, k rows, v rows, q keys, v keys).
template <int D, bool kAttn, bool kMix>
__global__ void __launch_bounds__(kThreads)
    sums_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ stats,
                const float* __restrict__ ex, float* __restrict__ mix,
                float* attn, int H, int N, int mode, float c,
                float out_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int T = kTile * D;
  constexpr int NT = kMix ? 6 : 2;
  constexpr int P = kMix ? 4 : 1;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * kTile;
  const int b = blockIdx.z;

  auto prefetch = [&](int h) {
    bf16* st = ring + (h & 1) * NT * T;
    const size_t base = ((size_t)b * H + h) * N * D;
    load_tile<D>(st, q + base, r0, N);
    load_tile<D>(st + T, k + base, k0, N);
    if constexpr (kMix) {
      load_tile<D>(st + 2 * T, k + base, r0, N);
      load_tile<D>(st + 3 * T, v + base, r0, N);
      load_tile<D>(st + 4 * T, q + base, k0, N);
      load_tile<D>(st + 5 * T, v + base, k0, N);
    }
    cp_async_commit();
  };

  float acc_attn[8][4], acc_mix[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_attn[j][e] = acc_mix[j][e] = 0.f;

  // acc[j][e] += 2^(S c - m c) * w, the row's statistics in (mc, w)
  auto add_softmax = [&](float(&acc)[8][4], const float(&S)[8][4],
                         const float(&mc)[2], const float(&w)[2]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = fmaf(exp2f(fmaf(S[j][e], c, -mc[e >> 1])), w[e >> 1],
                         acc[j][e]);
  };

  prefetch(0);
  for (int h = 0; h < H; ++h) {
    if (h + 1 < H) prefetch(h + 1);
    // this head's row statistics, loaded while the copies land; rows >= N
    // take (0, 0): p = 0
    float mc[P][2], w[P][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + warp * 16 + g + 8 * i;
      const float2* srow = reinterpret_cast<const float2*>(
          stats + (((size_t)b * H + h) * N + (row < N ? row : 0)) * (2 * P));
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float2 x = row < N ? __ldg(srow + p) : make_float2(0.f, 0.f);
        mc[p][i] = x.x;
        w[p][i] = p == 0 ? x.y : x.y * (1.f / 3.f);
      }
    }
    cp_async_wait_step(h + 1 < H);
    __syncthreads();
    const bf16* st = ring + (h & 1) * NT * T;
    uint32_t a[D / 16][4];
    float S[8][4];
    load_a<D>(a, st, warp * 16);
    if constexpr (kAttn) {
      warp_logits<D>(S, a, st + T);
      add_softmax(acc_attn, S, mc[0], w[0]);
    }
    if constexpr (kMix) {
      warp_logits<D>(S, a, st + 4 * T);
      add_softmax(acc_mix, S, mc[1], w[1]);
      load_a<D>(a, st + 2 * T, warp * 16);
      warp_logits<D>(S, a, st + T);
      add_softmax(acc_mix, S, mc[2], w[2]);
      load_a<D>(a, st + 3 * T, warp * 16);
      warp_logits<D>(S, a, st + 5 * T);
      add_softmax(acc_mix, S, mc[3], w[3]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + warp * 16 + g + 8 * (e >> 1);
      const int key = k0 + j * 8 + 2 * t + (e & 1);
      if (row >= N || key >= N) continue;
      const size_t i = ((size_t)b * N + row) * N + key;
      if constexpr (kMix)
        mix[i] = ex != nullptr ? fmaf((float)H, ex[i], acc_mix[j][e])
                               : acc_mix[j][e];
      if constexpr (kAttn) {
        // a product rounded on its own: mode acc == mode out + the
        // accumulator bit for bit (no contraction into an FMA)
        const float x = __fmul_rn(acc_attn[j][e], out_scale);
        attn[i] = mode == 2 ? attn[i] + x : x;
      }
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D, bool kSurgery>
cudaError_t launch_rows(const bf16* q, const bf16* k, const bf16* v, bf16* ctx,
                        float* stats, int B, int H, int N,
                        cudaStream_t stream) {
  auto kern = rows_kernel<D, kSurgery>;
  const size_t smem =
      sizeof(bf16) * kTile * D * (kSurgery ? 3 + 2 * 3 : 1 + 2 * 2);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTile - 1) / kTile, H, B);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, ctx, stats, H, N,
                                         scale_log2e(D));
  return cudaGetLastError();
}

template <int D, bool kAttn, bool kMix>
cudaError_t launch_sums(const bf16* q, const bf16* k, const bf16* v,
                        const float* stats, const float* ex, float* mix,
                        float* attn, int B, int H, int N, int mode,
                        float out_scale, cudaStream_t stream) {
  auto kern = sums_kernel<D, kAttn, kMix>;
  const size_t smem = sizeof(bf16) * kTile * D * 2 * (kMix ? 6 : 2);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nt = (N + kTile - 1) / kTile;
  dim3 grid(nt, nt, B);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, stats, ex, mix, attn, H, N,
                                         mode, scale_log2e(D), out_scale);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace excel
