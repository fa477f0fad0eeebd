// Tensor-core attention for bf16 q/k/v: the two kernels behind the bf16
// entry points of attention_plain.cu and attention_surgery.cu.
// attention_common.cuh says what the two kernels do; this file is their
// bf16 arithmetic, at head dims 32, 64, 72 and 80 (80 = 5 k-steps of 16: the
// k-steps, the P V column pairs and the tile layout follow D). D = 72 (9
// chunks of 16 bytes a row, 4.5 k-steps) runs in D = 80's tiles with the
// tenth chunk of every row zero-filled by the copies (`tile_dim`): the
// fifth k-step of every product adds eight zero products, and P V forms
// ten column pairs of which the ninth is the last written.
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
// conflict and without padding (`swz`: D = 80 splits its rows in two).
//
// The rows kernel's ring stage holds the chunk's K, V (and Q for surgery),
// copied by its threads (cp.async). The sums kernel's two stages each hold
// one head's tiles (q rows and k keys; for the mix also k rows, v rows, q
// keys, v keys; and surgery's row statistics), copied by the copy engine
// (TMA, one thread issuing, a barrier a stage), and keep both head sums of
// its 64 x 64 patch in registers: surgery's in eight warps of 16 rows x 32
// keys (at D = 80 four warps of 16 x 64 held 255 registers and spilled),
// plain attention's head-mean in four of 16 x 64.
#pragma once

#include <cuda.h>
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

// The tiles' width for head dim D: D itself, or 80 for D = 72 (its tenth
// 16-byte chunk a row zero).
template <int D>
__host__ __device__ constexpr int tile_dim() {
  return D == 72 ? 80 : D;
}

// Element offset of the 16-byte chunk c of row r in a swizzled [64][D] tile:
// 8 consecutive rows at one c land on 8 different bank groups. D = 80 has
// ten chunks a row (160 bytes: row-major, rows r and r + 4 would share a
// bank group), so its tile is two: chunks 0-7 of every row as D = 64's
// [64][64] tile, then chunks 8 and 9 as a [64][16] tile whose two chunks
// swap every four rows.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(D == 32 || D == 64 || D == 80, "head dims 32, 64, 80");
  if constexpr (D == 64) {
    return r * 64 + ((c ^ (r & 7)) << 3);
  } else if constexpr (D == 32) {
    return r * 32 + ((c ^ ((r >> 1) & 3)) << 3);
  } else {
    return c < 8 ? r * 64 + ((c ^ (r & 7)) << 3)
                 : kTile * 64 + r * 16 + (((c - 8) ^ ((r >> 2) & 1)) << 3);
  }
}

// Rows [r0, r0 + 64) of the row-major [n, D] matrix src into the tile dst
// ([64][tile_dim<D>]); rows >= n, and the chunks beyond D, are zero. Starts
// cp.async copies only: commit and wait are the caller's.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int n) {
  constexpr int DP = tile_dim<D>();
  constexpr bool kPad = DP != D;
  constexpr int C = DP / 8;
#pragma unroll
  for (int it = 0; it < kTile * C / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / C;
    const int c = i % C;
    const bool ok = r0 + r < n && (!kPad || c < D / 8);
    cp_async16(dst + swz<DP>(r, c),
               src + (size_t)(ok ? r0 + r : 0) * D +
                   (kPad ? (ok ? c * 8 : 0) : c * 8),
               ok);
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

// warp_logits over the kKeys keys [key0, key0 + kKeys) of the tile Bt (S[j]:
// keys key0 + 8 j ..), with the A fragments (rows [row0, row0 + 16) of the
// tile At) loaded one k-step at a time, for the sums kernel: at D = 80 all
// five k-steps held beside both head sums spill (ptxas: 708 bytes), and at
// D = 32 and 64 it is as fast as holding them. Each S[j] takes the same
// products in the same k-step order as warp_logits: the same bits.
template <int D, int kKeys>
__device__ __forceinline__ void warp_logits_streamed(float (&S)[kKeys / 8][4],
                                                     const bf16* At, int row0,
                                                     const bf16* Bt,
                                                     int key0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldsm4(a, At + swz<D>(row0 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
    for (int jp = 0; jp < kKeys / 16; ++jp) {
      const int key = key0 + jp * 16 + (lane & 7) + ((lane >> 4) << 3);
      uint32_t b[4];
      ldsm4(b, Bt + swz<D>(key, 2 * ks + ((lane >> 3) & 1)));
      mma16816(S[2 * jp], a, b[0], b[1]);
      mma16816(S[2 * jp + 1], a, b[2], b[3]);
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
  constexpr int DP = tile_dim<D>();
  constexpr int T = kTile * DP;
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

  uint32_t aq[DP / 16][4];
  RowStat st[P];
#pragma unroll
  for (int p = 0; p < P; ++p) stat_init(st[p]);
  float O[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[j][e] = 0.f;

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) prefetch(step + 1);
    cp_async_wait_step(step + 1 < steps);
    __syncthreads();
    if (step == 0) load_a<DP>(aq, At, warp * 16);
    const bf16* stg = ring + (step & 1) * NB * T;
    const bool pass1 = step < nc;
    const int c0 = (pass1 ? step : step - nc) * kTile;
    const bool ragged = c0 + kTile > N;
    float S[8][4];
    warp_logits<DP>(S, aq, stg);
    if (ragged) mask_keys(S, c0, N);
    if (pass1) {
      stat_update(st[0], S, c);
      if constexpr (kSurgery) {
        warp_logits<DP>(S, aq, stg + 2 * T);
        if (ragged) mask_keys(S, c0, N);
        stat_update(st[1], S, c);
        uint32_t a2[DP / 16][4];
        load_a<DP>(a2, At + T, warp * 16);
        warp_logits<DP>(S, a2, stg);
        if (ragged) mask_keys(S, c0, N);
        stat_update(st[2], S, c);
        load_a<DP>(a2, At + 2 * T, warp * 16);
        warp_logits<DP>(S, a2, stg + T);
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
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t bv[4];
          ldsm4_trans(bv, Vt + swz<DP>(key, 2 * dp + (lane >> 4)));
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
    // ctx token-major: [B, N, H, D]
    bf16* out = ctx + (((size_t)b * N + row) * H + h) * D + 2 * t;
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

// How a sums kernel block covers its 64 x 64 patch: each warp 16 rows x
// kWarpKeys (64 or 32) keys, so 4 or 8 warps; the blocks an SM its
// registers are held to (__launch_bounds__).
template <int kWarpKeys_, int kBlocks_>
struct SumsSplit {
  static constexpr int kWarpKeys = kWarpKeys_;
  static constexpr int kBlocks = kBlocks_;
  static constexpr int kThreadsBlock = kThreads * kTile / kWarpKeys;
};

// The sums kernel's copies: tensor maps of q, k, v ([B H][N][D] bf16; D =
// 80 and 72 as a box of columns 0-63 and one of 64-79, whose columns >= D
// the copy zero-fills) and of surgery's row statistics; rows >= N are
// zero-filled too. The boxes' swizzles lay the tiles out as swz does.
struct SumsMaps {
  CUtensorMap qkv[3][2];
  CUtensorMap stats;
};

// Tiles a stage: the row tiles q (, k, v) of the patch's 64 rows, then its
// key tiles k (, q, v).
template <bool kMix>
__host__ __device__ constexpr int sums_stage_tiles() {
  return kMix ? 6 : 2;
}

// floats of a stage's row statistics: 64 rows x 8 in surgery (plain
// attention's 2 a row, 8 bytes, make no box: its threads load their own)
template <bool kMix>
__host__ __device__ constexpr int sums_stat_floats() {
  return kMix ? kTile * 8 : 0;
}

// bytes a stage's copies write
template <int D, bool kMix>
__host__ __device__ constexpr int sums_stage_bytes() {
  return (int)sizeof(bf16) * kTile * tile_dim<D>() * sums_stage_tiles<kMix>() +
         (int)sizeof(float) * sums_stat_floats<kMix>();
}

// two stages, their barriers, and 1 KB to align the tiles to the 128-byte
// swizzle's 1024
template <int D, bool kMix>
__host__ __device__ constexpr size_t sums_smem() {
  return 2 * (sums_stage_bytes<D, kMix>() + sizeof(uint64_t)) + 1024;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for phase `parity` of the barrier; traps rather than hang should the
// copies never land
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}

// box (c0, c1, c2) of the map into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// Grid (key tiles, B, row tiles): the ragged last row tile of every image,
// whose warps below N alone work, comes last and fills the last wave. kAttn:
// attn = sum_h softmax(q k^T) (x out_scale; mode 2 adds the values already
// in attn). kMix: mix = sum_h (softmax(q q^T) + softmax(k k^T) + softmax(v
// v^T)) / 3 + H ex. Every element is one thread's: heads in order, in each
// head the products by mma.m16n8k16 over the k-steps in order, then acc =
// fma(2^(S c - m c), w, acc), q k^T into attn, then q q^T, k k^T, v v^T
// into mix; so the split changes no bit. A head's tiles (and surgery's
// statistics) arrive by the copy engine into one of two stages: one thread
// issues them, the stage's barrier counts their bytes, and the next head's
// land while this one is multiplied. Warps whose rows or keys lie wholly at
// or beyond N form nothing.
template <int D, bool kAttn, bool kMix, class Split>
__global__ void __launch_bounds__(Split::kThreadsBlock, Split::kBlocks)
    sums_kernel(const __grid_constant__ SumsMaps maps,
                const float* __restrict__ stats,
                const float* __restrict__ ex, float* __restrict__ mix,
                float* attn, int H, int N, int mode, float c,
                float out_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int DP = tile_dim<D>();
  constexpr int T = kTile * DP;
  constexpr int NR = kMix ? 3 : 1;  // row tiles: q (, k, v)
  constexpr int NT = sums_stage_tiles<kMix>();
  constexpr int P = kMix ? 4 : 1;
  constexpr int WK = Split::kWarpKeys;
  constexpr int SF = sums_stat_floats<kMix>();
  // both stages' tiles from a 1024-byte boundary, then their statistics,
  // then their barriers
  bf16* ring = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  float* stat_s = reinterpret_cast<float*>(ring + 2 * NT * T);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stat_s + 2 * SF);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (warp & 3) * 16;  // the warp's rows in the patch
  const int kw = (warp >> 2) * WK;   // the warp's first key in the patch
  const int k0 = blockIdx.x * kTile;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * kTile;
  const bool busy = r0 + row0 < N && k0 + kw < N;

  // head h's tiles and statistics into stage h & 1, by thread 0
  auto prefetch = [&](int h) {
    if (threadIdx.x != 0) return;
    bf16* st = ring + (h & 1) * NT * T;
    uint64_t* bar = bars + (h & 1);
    const int bh = b * H + h;
    mbar_expect_tx(bar, sums_stage_bytes<D, kMix>());
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      // rows q, k, v (maps 0, 1, 2), then keys k, q, v
      const int m = i < NR ? i : (i == NR ? 1 : i == NR + 1 ? 0 : 2);
      const int start = i < NR ? r0 : k0;
      tma_load(st + i * T, &maps.qkv[m][0], 0, start, bh, bar);
      if constexpr (DP == 80)
        tma_load(st + i * T + kTile * 64, &maps.qkv[m][1], 64, start, bh,
                 bar);
    }
    if constexpr (kMix)
      tma_load(stat_s + (h & 1) * SF, &maps.stats, 0, r0, bh, bar);
  };

  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc_attn[WK / 8][4], acc_mix[WK / 8][4];
#pragma unroll
  for (int j = 0; j < WK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_attn[j][e] = acc_mix[j][e] = 0.f;

  // acc[j][e] += 2^(S c - m c) * w over the product At . Bt^T of the warp's
  // rows and keys; x: the rows' statistics (m c, 1 / s) of the softmax, w
  // = 1 / s (x 1 / 3 in the mix); rows >= N (0, 0)
  auto add_softmax = [&](float(&acc)[WK / 8][4], const bf16* At,
                         const bf16* Bt, const float2(&x)[2], bool third) {
    float S[WK / 8][4];
    warp_logits_streamed<DP, WK>(S, At, row0, Bt, kw);
#pragma unroll
    for (int j = 0; j < WK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 s = x[e >> 1];
        const float w = third ? s.y * (1.f / 3.f) : s.y;
        acc[j][e] = fmaf(exp2f(fmaf(S[j][e], c, -s.x)), w, acc[j][e]);
      }
  };

  prefetch(0);
  for (int h = 0; h < H; ++h) {
    if (h + 1 < H) prefetch(h + 1);
    mbar_wait(bars + (h & 1), (h >> 1) & 1);
    if (busy) {
      const bf16* st = ring + (h & 1) * NT * T;
      const bf16* kt = st + NR * T;  // the key tiles
      const float2* sst =
          reinterpret_cast<const float2*>(stat_s + (h & 1) * SF);
      // softmax p's statistics of the thread's rows g and g + 8
      float2 x[2];
      auto stat = [&](int p) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = row0 + g + 8 * i;
          if constexpr (kMix)
            x[i] = sst[r * P + p];
          else
            x[i] = r0 + r < N
                       ? __ldg(reinterpret_cast<const float2*>(stats) +
                               ((size_t)b * H + h) * N + r0 + r)
                       : make_float2(0.f, 0.f);
        }
      };
      if constexpr (kAttn) {
        stat(0);
        add_softmax(acc_attn, st, kt, x, false);
      }
      if constexpr (kMix) {
        stat(1);
        add_softmax(acc_mix, st, kt + T, x, true);
        stat(2);
        add_softmax(acc_mix, st + T, kt, x, true);
        stat(3);
        add_softmax(acc_mix, st + 2 * T, kt + 2 * T, x, true);
      }
    }
    // every warp is done with this stage before it is filled again
    __syncthreads();
  }
  if (!busy) return;

#pragma unroll
  for (int j = 0; j < WK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + row0 + g + 8 * (e >> 1);
      const int key = k0 + kw + j * 8 + 2 * t + (e & 1);
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
  const size_t smem = sizeof(bf16) * kTile * tile_dim<D>() *
                      (kSurgery ? 3 + 2 * 3 : 1 + 2 * 2);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTile - 1) / kTile, H, B);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, ctx, stats, H, N,
                                         scale_log2e(D));
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to
// libcuda); null where the installed CUDA has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tiled map of the rank-`rank` tensor at p (dims innermost first, byte
// strides of dims 1..), boxes of `box` elements, zero outside the tensor
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* p, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = tensor_map_encoder();
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, (cuuint32_t)rank, const_cast<void*>(p), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of one sums launch: q, k, v as [B H][N][D] in boxes of 64 rows
// (swz's layout: 128-byte rows swizzled in 1024, D = 80's 32-byte tail in
// 256, D = 32's 64-byte rows in 512); surgery's statistics as [B H][N][8]
// in boxes of 64 rows
template <int D, bool kMix>
bool sums_maps(SumsMaps* maps, const bf16* q, const bf16* k, const bf16* v,
               const float* stats, int B, int H, int N) {
  constexpr int DP = tile_dim<D>();
  const bf16* src[3] = {q, k, v};
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N,
                              (cuuint64_t)B * H};
  const cuuint64_t strides[2] = {sizeof(bf16) * D,
                                 sizeof(bf16) * D * (cuuint64_t)N};
  const cuuint32_t head[3] = {DP == 32 ? 32u : 64u, (cuuint32_t)kTile, 1};
  const cuuint32_t tail[3] = {16, (cuuint32_t)kTile, 1};
  const CUtensorMapSwizzle swizzle = DP == 32
                                         ? CU_TENSOR_MAP_SWIZZLE_64B
                                         : CU_TENSOR_MAP_SWIZZLE_128B;
  for (int m = 0; m < 3; ++m) {
    if (!encode_map(&maps->qkv[m][0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    src[m], 3, dims, strides, head, swizzle))
      return false;
    if (DP == 80 &&
        !encode_map(&maps->qkv[m][1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    src[m], 3, dims, strides, tail,
                    CU_TENSOR_MAP_SWIZZLE_32B))
      return false;
  }
  if (!kMix) return true;
  const cuuint64_t sdims[3] = {8, (cuuint64_t)N, (cuuint64_t)B * H};
  const cuuint64_t sstrides[2] = {sizeof(float) * 8,
                                  sizeof(float) * 8 * (cuuint64_t)N};
  const cuuint32_t sbox[3] = {8, (cuuint32_t)kTile, 1};
  return encode_map(&maps->stats, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, stats, 3,
                    sdims, sstrides, sbox, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The split's kernel allowed its shared memory; the blocks of it an SM
// holds into *blocks, where not null
template <int D, bool kAttn, bool kMix, class Split>
cudaError_t sums_residency(int* blocks) {
  auto kern = sums_kernel<D, kAttn, kMix, Split>;
  constexpr size_t smem = sums_smem<D, kMix>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || blocks == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, Split::kThreadsBlock, smem);
}

// One launch of the sums kernel in the split Split.
template <int D, bool kAttn, bool kMix, class Split>
cudaError_t launch_sums_split(const bf16* q, const bf16* k, const bf16* v,
                              const float* stats, const float* ex, float* mix,
                              float* attn, int B, int H, int N, int mode,
                              float out_scale, cudaStream_t stream) {
  SumsMaps maps;
  if (!sums_maps<D, kMix>(&maps, q, k, v, stats, B, H, N))
    return cudaErrorInvalidValue;
  cudaError_t err = sums_residency<D, kAttn, kMix, Split>(nullptr);
  if (err != cudaSuccess) return err;
  const int nt = (N + kTile - 1) / kTile;
  sums_kernel<D, kAttn, kMix, Split>
      <<<dim3(nt, B, nt), Split::kThreadsBlock, sums_smem<D, kMix>(),
         stream>>>(maps, stats, ex, mix, attn, H, N, mode, scale_log2e(D),
                   out_scale);
  return cudaGetLastError();
}

// Plain attention's head-mean keeps four warps of 16 rows x 64 keys. The
// surgery sums run eight warps of 16 rows x 32 keys, with every register a
// thread may take (one block an SM: the two stages take 125 KB at D = 80
// and 72), or with 128, where the SM's shared memory then holds two blocks
// (D <= 64: 16 warps an SM); the launch asks the card which holds more.
template <int D, bool kAttn, bool kMix>
cudaError_t launch_sums(const bf16* q, const bf16* k, const bf16* v,
                        const float* stats, const float* ex, float* mix,
                        float* attn, int B, int H, int N, int mode,
                        float out_scale, cudaStream_t stream) {
  if constexpr (!kMix) {
    return launch_sums_split<D, kAttn, kMix, SumsSplit<64, 1>>(
        q, k, v, stats, ex, mix, attn, B, H, N, mode, out_scale, stream);
  } else {
    using Wide = SumsSplit<32, 1>;
    using Two = SumsSplit<32, 2>;
    int wide = 0, two = 0;
    cudaError_t err = sums_residency<D, kAttn, kMix, Wide>(&wide);
    if (err == cudaSuccess) err = sums_residency<D, kAttn, kMix, Two>(&two);
    if (err != cudaSuccess) return err;
    if (two > wide)
      return launch_sums_split<D, kAttn, kMix, Two>(
          q, k, v, stats, ex, mix, attn, B, H, N, mode, out_scale, stream);
    return launch_sums_split<D, kAttn, kMix, Wide>(
        q, k, v, stats, ex, mix, attn, B, H, N, mode, out_scale, stream);
  }
}

}  // namespace tc
}  // namespace excel
