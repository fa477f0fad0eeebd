// One diffusion step over unpadded masks, fp32 or bf16: PAR's step, and the
// message pass of the convolutional mean-field CRF (ops/crf_tpu.py).
//
// Replaces the TPU kernels excel_tpu/ops/par_pallas.py `_diffuse_kernel`
// (:31, called by par_diffuse; Pallas row 5) on the per-step route of
// excel_tpu/ops/par.py:340-350 and in excel_tpu/ops/crf_tpu.py:266-283,
// and `_diffuse_hcw_kernel` (:508; row 8), the full-extent padded fp32
// step, whose edge-padded canvas holds what the clamped reads here see:
//
//   out[b, c, y, x] = sum_k aff[b, k, y, x] * m[b, c, cy(y + dy_k), cx(x + dx_k)]
//
// with cy, cx clamping to the canvas, which equals reading an edge-padded
// copy (the TPU kernels' input), pads beyond the image included.
//
// Arithmetic. fp32: each product and each sum rounded once (__fmul_rn,
// __fadd_rn: nvcc contracts neither into an FMA), summed from 0 in offset
// order, which is the plain version's order, so the two agree bit for bit.
// bf16 (masks, affinities and output in bf16: the fast preset's CRF
// messages): each product rounded to bf16 (__hmul2_rn on a pixel pair; a
// product of two bf16 values is exact in fp32, so its one rounding is the
// TPU kernel's `(a * m).astype(f32)`), the products of a chunk of 8 offsets
// summed in fp32 in offset order, each chunk's sum rounded to bf16 and added
// onto the bf16 running output with one more rounding: out = bf16(part_0),
// then out = bf16(out + bf16(part_q)).
//
// What bounds it. At the fp32 PAR step (B=16, C=4, K=48, 384x512) bytes:
// a step reads 604 MB of affinities and 50 MB of masks and writes 50 MB,
// 0.21 ms at 3.35 TB/s; row 8 at the train step's [4, 5, 320, 320] 0.028
// ms. At the CRF's [4, 21, 384, 512], K=72, pad 55, fp32 bytes again, 0.107
// ms; bf16 operations: its 0.054 ms of bytes are less than 1.19 G products
// at 64 an SM and clock (a bf16 -> fp32 placement on the 64-lane integer
// pipe beside each FADD; fp32's FMUL + FADD on 128 lanes is the same rate)
// on 132 SMs at 1.98 GHz, 0.071 ms. What holds the kernel above these is
// the traffic from L2 that the halo costs: the halo of a 32 x 64 tile at
// pad 55 is 7x the tile, so shared memory holds 2 fp32 or 4 bf16 channels
// and the affinities are read once per channel pass (tools/par_ab.py
// prints the bounds; PERF.md has the times and ablations).
//
// Design (the previous one: a thread a pixel, a block a row, K x C scalar
// loads of neighbours from L1/L2 with clamps, affinities re-read per group
// of 8 channels):
// - Tiles of 32 x 64 output pixels, a block of 512 threads each; lane l of
//   warp v owns rows v and v + 16 and, in fp32, columns l and l + 32 (every
//   shared load of a warp is then 32 consecutive words, conflict-free for
//   any column shift), in bf16 the pixel pair 2l, 2l + 1 (one __hmul2_rn
//   multiplies the pair's two affinities by its two neighbours).
// - The tile's masks with a halo of P rows and Pa columns (P rounded up to
//   16 bytes), clamped to the canvas, are staged once in shared memory for
//   the channels of a pass side by side, by 16-byte cp.async copies where a
//   row segment lies inside the image and is aligned, else element by
//   element. The inner loop reads them at a per-offset shift from a table,
//   with no clamp and no bound.
// - Affinities go from global memory straight to the registers of the lane
//   that uses them (each is used by one lane), coalesced, one chunk of 8
//   offsets ahead of the sums.
// - Channel passes: a pass holds NC <= 8 channels (a template parameter, so
//   the sums live in registers); C takes the fewest passes of equal width
//   whose staged planes fit shared memory (PAR's C=4 and row 8's C=5: one;
//   C=9: 5 + 5, the last pass starting at channel 4). A tile's passes are
//   consecutive blocks, which run at about the same time, so the other
//   passes read the tile's affinities from L2.
// - The staged pad P is the caller's choice (ops/par_kernels.staged_pad):
//   chunks of 8 offsets that reach beyond it ("far") read their neighbours
//   from global memory at clamped positions, one offset's loads at a time.
//   A smaller halo holds more channels and so needs fewer passes over the
//   affinities: the fp32 CRF stages pad 21 (6 channels a pass, 4 passes;
//   dilations 34 and 55 far) instead of 55 (2 a pass, 11 passes). The far
//   path has its own instantiation: its registers would make the others
//   spill. bf16 stages its whole pad: its far reads (2-byte pairs, odd
//   shifts) cost more than the passes they save (PERF.md).
// - bf16 chunks whose column shifts are all even read each neighbour pair
//   with one aligned 4-byte load; chunks with an odd shift (the CRF's
//   dilations 1, 3, 5, 13, 21, 55) take two 2-byte loads. A product goes to
//   fp32 by placing its bits (integer units, not the conversion unit).
// - Ragged shapes: rows past the image's bottom and columns past its right
//   edge are summed from the clamped staging and not stored; affinity and
//   output pairs fall back to single elements where the width is odd or a
//   base pointer is not 4-byte aligned; any h, w >= 1, a pad beyond the
//   image included.
// - No atomics: every run gives the same bits.
// Compiler report (nvcc -Xptxas -v, sm_90a; `tools/par_ab.py --check`
// prints it): 24 instantiations (1-8 channels a pass in bf16, in fp32, and
// in fp32 with far chunks), 72-128 registers; the far fp32 ones at 5-8
// channels spill 56-88 bytes, the others none.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 32;        // output rows of a tile
constexpr int kTW = 64;        // output columns of a tile
constexpr int kThreads = 512;  // kTH / 2 warps: two rows a lane
constexpr int kChunk = 8;      // offsets per chunk (bf16: per fp32 sum)
constexpr int kMaxPass = 8;    // channels of a pass

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

struct Geo {
  int B, C, H, W, K, P;
  int Pa;      // column halo: P rounded up to 16 bytes of elements
  int sw;      // staged row length: kTW + 2 Pa
  int plane;   // staged positions of a channel: (kTH + 2P) x sw
  int tx, ty;  // tiles across and down an image
  int npass, nc;
  bool pairs;  // bf16: affinity and output pairs may be 4-byte accesses
};

__device__ inline unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ inline void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ inline void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// the tile's masks of channels [c0, c0 + nc) with their halo, clamped to the
// canvas -> nc shared planes of (kTH + 2P) x sw
template <typename T>
__device__ void stage(const T* __restrict__ m, const Geo& g, int b, int c0,
                      int nc, int y0, int x0, T* halo) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte copy
  const int rows = kTH + 2 * g.P, nv = g.sw / E;
  const int n = nc * rows * nv;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int v = i % nv, r = i / nv % rows, c = i / (nv * rows);
    const int gy = min(max(y0 - g.P + r, 0), g.H - 1);
    const T* row = m + ((size_t)(b * g.C + c0 + c) * g.H + gy) * g.W;
    const int gx = x0 - g.Pa + v * E;
    T* d = halo + ((size_t)c * rows + r) * g.sw + v * E;
    if (gx >= 0 && gx + E <= g.W && ((uintptr_t)(row + gx) & 15) == 0) {
      cp16(d, row + gx);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = row[min(max(gx + e, 0), g.W - 1)];
    }
  }
  cp_commit();
}

// the block's tile and channel pass: channels [c0, c0 + nc); the last pass
// starts C - nc channels in, so that every pass holds nc channels (the
// channels two passes share are summed by both and written with the same
// bits)
struct Unit {
  int b, y0, x0, c0;
};

__device__ inline Unit unit_of(const Geo& g) {
  Unit u;
  const int pass = blockIdx.x % g.npass, t = blockIdx.x / g.npass;
  u.b = t / (g.tx * g.ty);
  u.y0 = t / g.tx % g.ty * kTH;
  u.x0 = t % g.tx * kTW;
  u.c0 = min(pass * g.nc, g.C - g.nc);
  return u;
}

// the shared tables: [K] per-offset shift into a staged plane, then [nq]
// 1 for a far chunk (an offset beyond the staged pad P: its neighbours are
// read from global memory, clamped, not from the staged halo)
__host__ __device__ inline size_t table_bytes(int K) {
  return ((size_t)K + (K + kChunk - 1) / kChunk + 3) / 4 * 16;
}

__device__ inline void fill_tables(const int* __restrict__ offsets,
                                   const Geo& g, int* delta, int* far) {
  for (int k = threadIdx.x; k < g.K; k += kThreads)
    delta[k] = (g.P + __ldg(offsets + 2 * k)) * g.sw + g.Pa +
               __ldg(offsets + 2 * k + 1);
  const int q = threadIdx.x;
  if (q * kChunk < g.K) {
    int reach = 0;
    for (int k = q * kChunk; k < min(q * kChunk + kChunk, g.K); ++k)
      reach = max(reach, max(abs(__ldg(offsets + 2 * k)),
                             abs(__ldg(offsets + 2 * k + 1))));
    far[q] = reach > g.P;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- fp32 --

// a lane's affinities of one chunk: [offset][row][column]
__device__ inline void load_aff_f32(const float* __restrict__ a,
                                    const Geo& g, int k0, size_t hw,
                                    const bool (&ok)[2][2],
                                    float (&dst)[kChunk][2][2]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dst[j][r][e] = k0 + j < g.K && ok[r][e]
                           ? __ldg(a + (size_t)(k0 + j) * hw +
                                   (size_t)r * (kTH / 2) * g.W + 32 * e)
                           : 0.f;
}

// kFar: some chunks reach beyond the staged pad (a separate instantiation:
// the far path's registers would make the others spill)
template <int NC, bool kFar>
__global__ void __launch_bounds__(kThreads, 1)
    diffuse_f32(const float* __restrict__ m, const float* __restrict__ aff,
                const int* __restrict__ offsets, float* __restrict__ out,
                Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* delta = reinterpret_cast<int*>(smem);
  int* far = delta + g.K;
  float* halo = reinterpret_cast<float*>(smem + table_bytes(g.K));
  const Unit u = unit_of(g);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  fill_tables(offsets, g, delta, far);
  stage(m, g, u.b, u.c0, NC, u.y0, u.x0, halo);

  const size_t hw = (size_t)g.H * g.W;
  const int y = u.y0 + warp, x = u.x0 + lane;
  bool ok[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      ok[r][e] = y + r * (kTH / 2) < g.H && x + 32 * e < g.W;
  // (the address of an out-of-image pixel is formed, never dereferenced)
  const float* a = aff + (size_t)u.b * g.K * hw + (size_t)y * g.W + x;
  float cur[kChunk][2][2], next[kChunk][2][2];
  load_aff_f32(a, g, 0, hw, ok, cur);
  cp_wait_all();
  __syncthreads();

  float acc[NC][2][2];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) acc[c][r][e] = 0.f;
  const float* m0 = halo + warp * g.sw + lane;
  const float* mb = m + ((size_t)u.b * g.C + u.c0) * hw;
  for (int k0 = 0; k0 < g.K; k0 += kChunk) {
    if (k0 + kChunk < g.K) load_aff_f32(a, g, k0 + kChunk, hw, ok, next);
    if (kFar && far[k0 / kChunk]) {
      // neighbours beyond the staged pad: global memory, clamped
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (k0 + j >= g.K) break;
        const int dy = __ldg(offsets + 2 * (k0 + j));
        const int dx = __ldg(offsets + 2 * (k0 + j) + 1);
        int at[2][2];  // (an image plane has fewer than 2^31 pixels)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            at[r][e] = min(max(y + r * (kTH / 2) + dy, 0), g.H - 1) * g.W +
                       min(max(x + 32 * e + dx, 0), g.W - 1);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc[c][r][e] = __fadd_rn(
                  acc[c][r][e],
                  __fmul_rn(cur[j][r][e], __ldg(mb + c * hw + at[r][e])));
        // one offset's loads in flight at a time: hoisting all 8 offsets'
        // loads would need 32 x NC registers
        asm volatile("" ::: "memory");
      }
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (k0 + j >= g.K) break;
        const float* p = m0 + delta[k0 + j];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc[c][r][e] = __fadd_rn(
                  acc[c][r][e],
                  __fmul_rn(cur[j][r][e],
                            p[c * g.plane + r * (kTH / 2) * g.sw + 32 * e]));
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) cur[j][r][e] = next[j][r][e];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float* o = out + ((size_t)u.b * g.C + u.c0 + c) * hw + (size_t)y * g.W + x;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (ok[r][e]) o[(size_t)r * (kTH / 2) * g.W + 32 * e] = acc[c][r][e];
  }
}

// ---------------------------------------------------------------- bf16 --

__device__ inline unsigned bits_of(bf162 v) {
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ inline bf162 pair_of(unsigned v) {
  return *reinterpret_cast<const bf162*>(&v);
}
__device__ inline unsigned ld_u16(const bf16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// a lane's affinity pairs of one chunk: [offset][row], as bf162 bits
__device__ inline void load_aff_bf16(const bf16* __restrict__ a,
                                     const Geo& g, int k0, size_t hw,
                                     const bool (&ok)[2][2],
                                     unsigned (&dst)[kChunk][2]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bf16* p = a + (size_t)(k0 + j) * hw + (size_t)r * (kTH / 2) * g.W;
      unsigned v = 0;
      if (k0 + j < g.K) {
        if (g.pairs && ok[r][1])
          v = __ldg(reinterpret_cast<const unsigned*>(p));
        else
          v = (ok[r][0] ? ld_u16(p) : 0u) |
              (ok[r][1] ? ld_u16(p + 1) << 16 : 0u);
      }
      dst[j][r] = v;
    }
}

// the neighbour pair of channel c of the lane's pair in row r at offset j
// of the chunk, as bf162 bits, from the staged halo (kEven: every column
// shift of the chunk is even, so one aligned 4-byte load; else two 2-byte
// loads)
template <bool kEven>
struct StagedPairs {
  const bf16* m0;
  const int* delta;  // of the chunk's first offset
  int plane, sw;
  __device__ unsigned operator()(int j, int r, int c) const {
    const bf16* q = m0 + delta[j] + c * plane + r * (kTH / 2) * sw;
    return kEven ? *reinterpret_cast<const unsigned*>(q)
                 : ld_u16(q) | ld_u16(q + 1) << 16;
  }
};

// one chunk's rounded products summed left to right in fp32 and folded
// into the bf16 running output
template <int NC, class Pairs>
__device__ inline void chunk_bf16(const Pairs& pairs, int k0, int nk,
                                  const unsigned (&a)[kChunk][2],
                                  unsigned (&acc)[NC][2]) {
  float part[NC][2][2];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j >= nk) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const unsigned prod =
            bits_of(__hmul2_rn(pair_of(a[j][r]), pair_of(pairs(j, r, c))));
        const float t0 = __uint_as_float(prod << 16);
        const float t1 = __uint_as_float(prod & 0xffff0000u);
        part[c][r][0] = j == 0 ? t0 : __fadd_rn(part[c][r][0], t0);
        part[c][r][1] = j == 0 ? t1 : __fadd_rn(part[c][r][1], t1);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bf162 s = __floats2bfloat162_rn(part[c][r][0], part[c][r][1]);
      if (k0 == 0) {
        acc[c][r] = bits_of(s);
      } else {
        const unsigned o = acc[c][r], sb = bits_of(s);
        acc[c][r] = bits_of(__floats2bfloat162_rn(
            __fadd_rn(__uint_as_float(o << 16), __uint_as_float(sb << 16)),
            __fadd_rn(__uint_as_float(o & 0xffff0000u),
                      __uint_as_float(sb & 0xffff0000u))));
      }
    }
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    diffuse_bf16(const bf16* __restrict__ m, const bf16* __restrict__ aff,
                 const int* __restrict__ offsets, bf16* __restrict__ out,
                 Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* delta = reinterpret_cast<int*>(smem);
  int* far = delta + g.K;  // all 0: bf16 stages every offset's reach
  bf16* halo = reinterpret_cast<bf16*>(smem + table_bytes(g.K));
  const Unit u = unit_of(g);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  fill_tables(offsets, g, delta, far);
  stage(m, g, u.b, u.c0, NC, u.y0, u.x0, halo);

  const size_t hw = (size_t)g.H * g.W;
  const int y = u.y0 + warp, x = u.x0 + 2 * lane;
  bool ok[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      ok[r][e] = y + r * (kTH / 2) < g.H && x + e < g.W;
  const bf16* a = aff + (size_t)u.b * g.K * hw + (size_t)y * g.W + x;
  unsigned cur[kChunk][2], next[kChunk][2];
  load_aff_bf16(a, g, 0, hw, ok, cur);
  cp_wait_all();
  __syncthreads();

  unsigned acc[NC][2];
  const bf16* m0 = halo + warp * g.sw + 2 * lane;
  for (int k0 = 0; k0 < g.K; k0 += kChunk) {
    if (k0 + kChunk < g.K) load_aff_bf16(a, g, k0 + kChunk, hw, ok, next);
    const int nk = min(kChunk, g.K - k0);
    int odd = 0;
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < nk) odd |= delta[k0 + j];
    if (odd & 1)
      chunk_bf16<NC>(StagedPairs<false>{m0, delta + k0, g.plane, g.sw}, k0,
                     nk, cur, acc);
    else
      chunk_bf16<NC>(StagedPairs<true>{m0, delta + k0, g.plane, g.sw}, k0,
                     nk, cur, acc);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) cur[j][r] = next[j][r];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    bf16* o = out + ((size_t)u.b * g.C + u.c0 + c) * hw + (size_t)y * g.W + x;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* q = o + (size_t)r * (kTH / 2) * g.W;
      if (g.pairs && ok[r][1]) {
        *reinterpret_cast<unsigned*>(q) = acc[c][r];
      } else {
        const bf162 v = pair_of(acc[c][r]);
        if (ok[r][0]) q[0] = v.x;
        if (ok[r][1]) q[1] = v.y;
      }
    }
  }
}

// ------------------------------------------------------------- launch --

template <typename T>
size_t smem_bytes(const Geo& g, int nc) {
  return table_bytes(g.K) + (size_t)nc * g.plane * sizeof(T);
}

template <typename T, int NC, bool kFar>
int launch(const T* m, const T* aff, const int* offsets, T* out, Geo g,
           cudaStream_t stream) {
  const void* kernel;
  if constexpr (sizeof(T) == 4)
    kernel = (const void*)diffuse_f32<NC, kFar>;
  else
    kernel = (const void*)diffuse_bf16<NC>;
  const size_t smem = smem_bytes<T>(g, NC);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = g.B * g.ty * g.tx * g.npass;
  if constexpr (sizeof(T) == 4)
    diffuse_f32<NC, kFar><<<blocks, kThreads, smem, stream>>>(m, aff, offsets,
                                                              out, g);
  else
    diffuse_bf16<NC><<<blocks, kThreads, smem, stream>>>(m, aff, offsets,
                                                         out, g);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const T* m, const T* aff, const int* offsets, T* out, int B, int C,
        int H, int W, int K, int P, int R, void* stream) {
  // (bf16 has no far path: it stages every offset's reach)
  if (B < 1 || C < 1 || H < 1 || W < 1 || K < 1 || P < 0 ||
      K > kChunk * kThreads || (sizeof(T) == 2 && R > P))
    return (int)cudaErrorInvalidValue;
  constexpr int E = 16 / sizeof(T);
  Geo g{};
  g.B = B, g.C = C, g.H = H, g.W = W, g.K = K, g.P = P;
  g.Pa = (P + E - 1) / E * E;
  g.sw = kTW + 2 * g.Pa;
  g.plane = (kTH + 2 * P) * g.sw;
  g.tx = (W + kTW - 1) / kTW;
  g.ty = (H + kTH - 1) / kTH;
  g.pairs = W % 2 == 0 && ((uintptr_t)aff & 3) == 0 &&
            ((uintptr_t)out & 3) == 0;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // channels a pass: the fewest equal passes of at most 8 channels whose
  // staged planes fit shared memory
  for (int passes = (C + kMaxPass - 1) / kMaxPass; passes <= C; ++passes) {
    const int nc = (C + passes - 1) / passes;
    if (smem_bytes<T>(g, nc) > (size_t)limit) continue;
    g.nc = nc;
    g.npass = (C + nc - 1) / nc;
    if ((size_t)g.B * g.ty * g.tx * g.npass > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (nc) {
#define EXCEL_PASS(N)                                                \
  case N:                                                            \
    return R > P ? launch<T, N, true>(m, aff, offsets, out, g, s)    \
                 : launch<T, N, false>(m, aff, offsets, out, g, s);
      EXCEL_PASS(1) EXCEL_PASS(2) EXCEL_PASS(3) EXCEL_PASS(4)
      EXCEL_PASS(5) EXCEL_PASS(6) EXCEL_PASS(7) EXCEL_PASS(8)
#undef EXCEL_PASS
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;  // the pad's halo of one channel does
                                      // not fit shared memory
}

}  // namespace

// m, out: [B, C, H, W]; aff: [B, K, H, W]; offsets: [K, 2] int32 (dy, dx),
// all on the device. P: the staged pad (a host-side choice, see
// ops/par_kernels.staged_pad); R: the offsets' reach, max |dy|, |dx|. fp32
// chunks of 8 offsets that reach beyond P read global memory; bf16 needs
// R <= P. Returns a cudaError_t (0 on success; cudaErrorInvalidValue where
// one channel's halo does not fit shared memory).
extern "C" int excel_par_diffuse_f32(const float* m, const float* aff,
                                     const int* offsets, float* out, int B,
                                     int C, int H, int W, int K, int P,
                                     int R, void* stream) {
  return run<float>(m, aff, offsets, out, B, C, H, W, K, P, R, stream);
}

// The same step with m, aff and out in bf16 (the rounding points above).
extern "C" int excel_par_diffuse_bf16(const void* m, const void* aff,
                                      const int* offsets, void* out, int B,
                                      int C, int H, int W, int K, int P,
                                      int R, void* stream) {
  return run<bf16>((const bf16*)m, (const bf16*)aff, offsets, (bf16*)out, B,
                   C, H, W, K, P, R, stream);
}
