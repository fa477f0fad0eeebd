// PAR diffusion on a bf16 padded canvas with the per-image valid-extent
// clamp fused in: one step (Pallas row 7), or all steps in one cooperative
// launch (row 9).
//
// Replaces the TPU kernels excel_tpu/ops/par_pallas.py
// `_diffuse_padded_valid_kernel` (:342, called by par_diffuse_padded_valid;
// row 6 reaches it at full extents) and `_diffuse_resident_kernel` (:654,
// called by par_diffuse_valid_resident). The canvas is [B, C, Hp, Wp] with
// the image at rows/columns [P, P + h) x [P, P + w) and (vh, vw) =
// valid_hw[b]. A step
//
//   acc[c, y, x] = sum over chunks of 8 offsets of
//                  (sum over the chunk of float(bf16(aff[k, y, x] *
//                   m[c, y + P + dy_k, x + P + dx_k])))
//   out[c, Y, X] = bf16(acc[c, clamp(Y - P, 0, vh - 1),
//                           clamp(X - P, 0, vw - 1)])
//
// for every canvas position (Y, X), slack included: each product is rounded
// once to bf16 (the TPU's `(a * m).astype(f32)`; a product of two bf16
// values is exact in fp32, so __hmul2_rn's one rounding is that rounding),
// then summed in fp32 within a chunk left to right and chunk by chunk, as
// par_pallas._accumulate_offsets does. The TPU kernel writes the rows >= vh
// from a border row carried from tile to tile in VMEM; here the block that
// owns a valid source pixel also writes every canvas position that clamps
// onto it, so no block waits for another within a step. The TPU's border is
// the same value (a one-hot sum of one number): the two agree bit for bit.
//
// What bounds it: device memory. At the fast eval batch's shapes (B=16,
// C=4, K=48, 384x512 in a 440x640 canvas) a step must read the valid
// pixels' affinities (263 MB of the 302 MB stack), read the canvas and write
// the next one (36 MB each). The stack is six times the 50 MiB L2, so every
// step streams it from HBM again: 20 steps take at least 20 x 335 MB / 3.35
// TB/s ~= 2.0 ms (L2 could hold at most 52 MB of a step's 335, so this
// counts up to 16% too many bytes). At the train step's shapes (B=4, C=5,
// 320x320) the stack is 39 MB and fits L2: the floor is one read of it plus
// 20 canvases in and out (2 x 5.8 MB a step), 270 MB ~= 0.08 ms.
//
// Design (the previous design took 0.45 ms a step at the eval shape):
// - Tiles of 32 x 64 valid source pixels, walked in image-major order by
//   persistent blocks of 512 threads; a lane owns two neighbouring pixels in
//   each of two rows, so the affinities of one offset are one aligned 4-byte
//   shared load and the two products one __hmul2_rn, for every channel of
//   the pass; the products go to fp32 by placing their bits (integer units,
//   not the conversion unit).
// - The affinities stream through a ring of 3 shared stages of [8 offsets x
//   32 x 64] (32 KB) filled with 16-byte cp.async copies: two chunks (64 KB
//   an SM) stay in flight while the third is summed. The ring runs on across
//   a block's tiles: a tile's last chunks are summed while the next tile's
//   first ones arrive. The previous design loaded one 2-byte value per
//   offset and thread (about 8 KB in flight an SM). The copies carry an L2
//   evict-first policy, so that the stream does not push the canvases out
//   of L2. Where the stack fits L2 (the train shape), keeping it there
//   between steps (evict-last, or the default policy) measured the same:
//   the kernel is not held by these bytes there (PERF.md).
// - The tile's canvas rows with their P-pixel halo are staged by 16-byte
//   cp.async copies too (channel planes side by side), issued as soon as
//   the last chunk of the previous tile is summed, so they overlap its
//   stores. Halo: (32 + 2P) x (64 + 2P) staged positions for 2,048 sums,
//   4.4x at P=24 (the previous design staged 9.6x through 2-byte loads).
// - One pass over the affinities for C <= 8 where it fits shared memory (the
//   channel count of a pass is a template parameter, so sums live in
//   registers); else the fewest equal passes that fit (C=9: 5 + 4; at P=24,
//   C=7: 4 + 3, C=13: 5 + 5 + 3). Shared memory for a pass of nc channels:
//   nc x (32 + 2P) x roundup8(64 + 2P) x 2 B + 96 KB + nc x 4 KB: 182 KiB at
//   C=4, P=24 (one block an SM), at most 6 channels at P=24.
// - Ragged shapes: a copy whose global address is not 16-byte aligned or
//   that would cross the row's end (w=61, odd Wp) goes element by element;
//   chunks with odd column offsets (P + dx odd) read their mask pairs as
//   two 2-byte loads; odd Wp writes element by element.
// - The resident entry point runs `num_iter` steps in one cooperative
//   launch (cudaLaunchCooperativeKernel, as many blocks as fit, at most one
//   per tile); cooperative_groups::this_grid().sync() separates the steps,
//   which ping-pong between the output and a scratch canvas (the input is
//   never written). Canvas reads that may follow another block's writes go
//   through L2 (cp.async.cg, ld.global.cg). The step entry point is the same
//   kernel with num_iter = 1 in an ordinary launch. No atomics: every run
//   gives the same bits, and the same bits as `num_iter` step launches.
// Compiler report (nvcc -Xptxas -v, sm_90a): 8 instantiations (1-8
// channels a pass), 128 registers (80 at one channel); the 6-channel one
// spills 36 bytes (24-byte stack frame), the others none.
// Times against the bound: PERF.md.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// A tile is kTH x kTW source pixels, summed by kTH / 2 warps: a lane owns
// two neighbouring pixels in each of kRows = 2 rows.
constexpr int kTH = 32;               // source rows of a tile
constexpr int kTW = 64;               // source columns of a tile: 2 a lane
constexpr int kRows = 2;              // rows of a thread
constexpr int kChunk = 8;             // offsets per fp32 partial sum
constexpr int kStages = 3;            // affinity ring
constexpr int kMaxK = 128;            // offsets the shared table holds
constexpr int kMaxP = 64;
constexpr int kMaxPass = 8;           // channels summed in one pass

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

struct Canvas {
  int B, C, h, w, Hp, Wp, K, P;
};

// the valid source pixels of one tile of one image
struct Tile {
  int b, y0, x0, rh, rw, vh, vw;
};

__host__ __device__ inline int staged_h(int P) { return kTH + 2 * P; }
__host__ __device__ inline int staged_w(int P) {
  return (kTW + 2 * P + 7) / 8 * 8;
}
__host__ __device__ inline int tiles_x(const Canvas& g) {
  return (g.w + kTW - 1) / kTW;
}
__host__ __device__ inline int num_tiles(const Canvas& g) {
  return g.B * ((g.h + kTH - 1) / kTH) * tiles_x(g);
}

// offset table, staged canvas (nc planes), affinity ring, sums of the tile
size_t smem_bytes(int nc, int P) {
  return kMaxK * sizeof(int) +
         ((size_t)nc * staged_h(P) * staged_w(P) +
          (size_t)kStages * kChunk * kTH * kTW + (size_t)nc * kTH * kTW) *
             sizeof(bf16);
}

__device__ inline bool tile_at(const Canvas& g, const int* __restrict__ valid,
                               int t, Tile* u) {
  const int tx = tiles_x(g), ty = (g.h + kTH - 1) / kTH;
  u->b = t / (tx * ty);
  u->y0 = (t / tx) % ty * kTH;
  u->x0 = t % tx * kTW;
  u->vh = min(max(__ldg(valid + 2 * u->b), 1), g.h);
  u->vw = min(max(__ldg(valid + 2 * u->b + 1), 1), g.w);
  u->rh = min(kTH, u->vh - u->y0);
  u->rw = min(kTW, u->vw - u->x0);
  return u->rh > 0 && u->rw > 0;
}

// the next tile at or after t (stride gridDim.x) with valid pixels
__device__ inline int next_tile(const Canvas& g, const int* valid, int t,
                                Tile* u) {
  const int tiles = num_tiles(g);
  while (t < tiles && !tile_at(g, valid, t, u)) t += gridDim.x;
  return t;
}

__device__ inline unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}
__device__ inline void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ inline void cp16_evict_first(void* dst, const void* src,
                                        uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "l"(policy));
}
__device__ inline void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ inline void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ inline unsigned short ld_cg(const bf16* p) {
  return __ldcg(reinterpret_cast<const unsigned short*>(p));
}

// canvas rows [y0, y0 + rh + 2P) x columns [x0, x0 + rw + 2P) of channels
// [c0, c0 + nc) (all inside [0, vh + 2P) x [0, vw + 2P)) -> shared planes;
// a half-warp a row, a lane per 16 bytes
__device__ void issue_canvas(const bf16* src, const Canvas& g, const Tile& u,
                             int c0, int nc, bf16* canvas) {
  const int sh = staged_h(g.P), sw = staged_w(g.P);
  const int rows = u.rh + 2 * g.P;
  const int vec = (u.rw + 2 * g.P + 7) / 8;
  const int half = threadIdx.x / 16, l16 = threadIdx.x % 16;
  for (int c = 0; c < nc; ++c) {
    for (int r = half; r < rows; r += kTH) {  // kTH half-warps
      const bf16* s = src + ((size_t)(u.b * g.C + c0 + c) * g.Hp + u.y0 + r) *
                                g.Wp + u.x0;
      bf16* d = canvas + ((size_t)c * sh + r) * sw;
      for (int v = l16; v < vec; v += 16) {
        if (u.x0 + 8 * v + 8 <= g.Wp && aligned16(s + 8 * v)) {
          cp16(d + 8 * v, s + 8 * v);
        } else {
          unsigned short* d16 = reinterpret_cast<unsigned short*>(d + 8 * v);
          for (int e = 0; e < 8 && u.x0 + 8 * v + e < g.Wp; ++e)
            d16[e] = ld_cg(s + 8 * v + e);
        }
      }
    }
  }
}

// affinities of chunk q (offsets [8q, 8q + 8)) at the tile's pixels ->
// one ring stage [8][kTH][kTW], 16 bytes a thread and copy
__device__ void issue_aff(const bf16* __restrict__ aff, const Canvas& g,
                          const Tile& u, int q, bf16* stage,
                          uint64_t policy) {
  constexpr int kVec = kTW / 8;
  const int k0 = q * kChunk, nk = min(kChunk, g.K - k0);
  const int vec = (u.rw + 7) / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kChunk * kTH * kVec; i += 16 * kTH) {
    const int v = i % kVec, r = i / kVec % kTH, j = i / (kVec * kTH);
    if (j >= nk || r >= u.rh || v >= vec) continue;
    const int x = u.x0 + 8 * v;
    const bf16* s =
        aff + ((size_t)(u.b * g.K + k0 + j) * g.h + u.y0 + r) * g.w + x;
    bf16* d = stage + (j * kTH + r) * kTW + 8 * v;
    if (x + 8 <= g.w && aligned16(s)) {
      cp16_evict_first(d, s, policy);
    } else {
      for (int e = 0; e < 8 && x + e < g.w; ++e) d[e] = __ldg(s + e);
    }
  }
}

// every canvas position whose clamped source lies in the tile takes that
// source's sum: a warp a row, two columns a lane
__device__ void write_out(bf16* dst, const Canvas& g, const Tile& u, int c0,
                          int nc, const bf16* sums) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ya = u.y0 == 0 ? 0 : u.y0 + g.P;
  const int yb = u.y0 + u.rh == u.vh ? g.Hp : u.y0 + u.rh + g.P;
  const int xa = u.x0 == 0 ? 0 : u.x0 + g.P;
  const int xb = u.x0 + u.rw == u.vw ? g.Wp : u.x0 + u.rw + g.P;
  const bool pairs = g.Wp % 2 == 0 && ((uintptr_t)dst & 3) == 0;
  for (int c = 0; c < nc; ++c) {
    for (int y = ya + warp; y < yb; y += kTH / 2) {
      const bf16* from =
          sums + (c * kTH + min(max(y - g.P, 0), u.vh - 1) - u.y0) * kTW;
      bf16* to = dst + ((size_t)(u.b * g.C + c0 + c) * g.Hp + y) * g.Wp;
      for (int x = (xa & ~1) + 2 * lane; x < xb; x += 64) {
        // a column outside [xa, xb) (the pair's other half) is not
        // written: its index only stays inside the row
        const bf16 v0 = from[min(max(x - g.P - u.x0, 0), u.rw - 1)];
        const bf16 v1 = from[min(max(x + 1 - g.P - u.x0, 0), u.rw - 1)];
        if (pairs && x >= xa && x + 1 < xb) {
          *reinterpret_cast<bf162*>(to + x) = __halves2bfloat162(v0, v1);
        } else {
          if (x >= xa) to[x] = v0;
          if (x + 1 >= xa && x + 1 < xb) to[x + 1] = v1;
        }
      }
    }
  }
}

// one chunk's sums at a thread's pixel pairs (one in each of its kRows
// rows): for each channel of the pass, the chunk's rounded products summed
// left to right, folded into acc. kFull: all 8 offsets of the chunk exist;
// kEven: every offset's staged column shift is even, so each mask pair is
// one aligned 4-byte load (else two 2-byte loads). Rows and channels past
// the tile's (and the pass's) are summed from stale shared memory and
// never stored: no guard stands between the loads and the products.
template <int NC, bool kFull, bool kEven>
__device__ inline void chunk_sums(const bf16* m0, const bf16* a0,
                                  const int (&d)[kChunk], int plane, int sw,
                                  int nk, bool first,
                                  float (&acc)[kRows][NC][2]) {
  float part[kRows][NC][2];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (!kFull && j >= nk) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bf162 a = *reinterpret_cast<const bf162*>(
          a0 + (j * kTH + r * kTH / 2) * kTW);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const bf16* p = m0 + c * plane + r * kTH / 2 * sw + d[j];
        const bf162 m = kEven ? *reinterpret_cast<const bf162*>(p)
                              : __halves2bfloat162(p[0], p[1]);
        const bf162 prod = __hmul2_rn(a, m);
        // bf16 -> fp32 by placing the bits (integer units; a cvt goes
        // through the slower conversion unit)
        const unsigned bits = *reinterpret_cast<const unsigned*>(&prod);
        const float t0 = __uint_as_float(bits << 16);
        const float t1 = __uint_as_float(bits & 0xffff0000u);
        part[r][c][0] = j == 0 ? t0 : __fadd_rn(part[r][c][0], t0);
        part[r][c][1] = j == 0 ? t1 : __fadd_rn(part[r][c][1], t1);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[r][c][e] =
            first ? part[r][c][e] : __fadd_rn(acc[r][c][e], part[r][c][e]);
}

// one step from src to dst over the tiles of this block (grid-stride,
// image-major), NC channels a pass
template <int NC>
__device__ void run_step(const bf16* src, bf16* dst,
                         const bf16* __restrict__ aff,
                         const int* __restrict__ valid, const Canvas& g,
                         unsigned char* smem, uint64_t policy) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* delta = reinterpret_cast<const int*>(smem);
  const int sh = staged_h(g.P), sw = staged_w(g.P);
  const int plane = sh * sw;
  bf16* canvas = reinterpret_cast<bf16*>(smem + kMaxK * sizeof(int));
  bf16* ring = canvas + (size_t)NC * plane;
  bf16* sums = ring + kStages * kChunk * kTH * kTW;
  const int tiles = num_tiles(g);
  const int nq = (g.K + kChunk - 1) / kChunk;
  const int npass = (g.C + NC - 1) / NC;

  constexpr int kStage = kChunk * kTH * kTW;
  constexpr int kAhead = kStages - 1;  // chunks in flight while one is summed
  // the ring runs on across the units (tile, channel pass) of a block: the
  // last chunks of a unit are summed while the next unit's first arrive;
  // s0 is the stage of the unit's chunk 0
  Tile u, un;
  int t = next_tile(g, valid, blockIdx.x, &u), pass = 0, s0 = 0;
  if (t < tiles) {
    issue_canvas(src, g, u, 0, min(NC, g.C), canvas);
    for (int j = 0; j < kAhead; ++j) {
      if (j < nq) issue_aff(aff, g, u, j, ring + j * kStage, policy);
      cp_commit();
    }
  }
  while (t < tiles) {
    const int c0 = pass * NC, nc = min(NC, g.C - c0);
    // the unit after this one: the next pass, or the next tile's first
    int tn = t, passn = pass + 1;
    un = u;
    if (passn == npass) {
      passn = 0;
      tn = next_tile(g, valid, t + gridDim.x, &un);
    }
    const bool more = tn < tiles;
    float acc[kRows][NC][2];
    for (int q = 0; q < nq; ++q) {
      // chunk q has landed (with the canvas, at q = 0) ...
      if (q == 0)
        cp_wait<0>();
      else
        cp_wait<kAhead - 1>();
      __syncthreads();  // ... for every thread; chunk q-1 is summed
      const int job = q + kAhead;
      bf16* slot = ring + (s0 + job) % kStages * kStage;
      if (job < nq)
        issue_aff(aff, g, u, job, slot, policy);
      else if (more && job - nq < nq)
        issue_aff(aff, g, un, job - nq, slot, policy);
      cp_commit();
      const bf16* stage = ring + (s0 + q) % kStages * kStage;
      const int k0 = q * kChunk, nk = min(kChunk, g.K - k0);
      int d[kChunk], odd = 0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        d[j] = delta[min(k0 + j, g.K - 1)];
        odd |= d[j];
      }
      const bf16* m0 = canvas + warp * sw + 2 * lane;
      const bf16* a0 = stage + warp * kTW + 2 * lane;
      if (nk == kChunk && !(odd & 1))
        chunk_sums<NC, true, true>(m0, a0, d, plane, sw, nk, q == 0,
                                       acc);
      else
        chunk_sums<NC, false, false>(m0, a0, d, plane, sw, nk, q == 0,
                                         acc);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int ry = warp + r * kTH / 2;
      if (ry >= u.rh) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c < nc)
          *reinterpret_cast<bf162*>(sums + (c * kTH + ry) * kTW + 2 * lane) =
              __floats2bfloat162_rn(acc[r][c][0], acc[r][c][1]);
    }
    __syncthreads();  // sums written; canvas and ring read
    // the next unit's canvas (and, for K <= 8, its chunk 0) loads while
    // this unit is written out
    const Tile done = u;
    const int s1 = (s0 + nq) % kStages;
    if (more) {
      issue_canvas(src, g, un, passn * NC, min(NC, g.C - passn * NC),
                   canvas);
      for (int j = 0; j < min(kAhead - nq, nq); ++j)
        issue_aff(aff, g, un, j, ring + (s1 + j) % kStages * kStage,
                      policy);
      cp_commit();
    }
    u = un;
    t = tn;
    pass = passn;
    s0 = s1;
    write_out(dst, g, done, c0, nc, sums);
  }
  cp_wait<0>();
}

template <int NC>
__global__ void __launch_bounds__(16 * kTH, 1)
    diffuse_kernel(const bf16* src, bf16* out, bf16* scratch,
                   const bf16* __restrict__ aff,
                   const int* __restrict__ valid,
                   const int* __restrict__ offsets, Canvas g, int num_iter) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* delta = reinterpret_cast<int*>(smem);  // offset k -> staged offset
  for (int k = threadIdx.x; k < g.K; k += blockDim.x)
    delta[k] = (g.P + __ldg(offsets + 2 * k)) * staged_w(g.P) + g.P +
               __ldg(offsets + 2 * k + 1);
  // (read only after the first chunk's __syncthreads)
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  const bf16* s = src;
  for (int it = 0; it < num_iter; ++it) {
    // the last step lands in `out`
    bf16* d = ((num_iter - 1 - it) & 1) ? scratch : out;
    if (it > 0) {
      __syncthreads();  // this block's writes of step it-1 are issued
      cg::this_grid().sync();  // every block's are visible
    }
    run_step<NC>(s, d, aff, valid, g, smem, policy);
    s = d;
  }
}

template <int NC>
int launch(const bf16* src, bf16* out, bf16* scratch, const bf16* aff,
           const int* valid, const int* offsets, Canvas g, int num_iter,
           cudaStream_t stream) {
  const void* kernel = (const void*)diffuse_kernel<NC>;
  const size_t smem = smem_bytes(NC, g.P);
  const int threads = 16 * kTH, tiles = num_tiles(g);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int fit = per_sm * sms;
  const int blocks = fit < tiles ? fit : tiles;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  if (num_iter == 1) {
    diffuse_kernel<NC><<<blocks, threads, smem, stream>>>(
        src, out, scratch, aff, valid, offsets, g, num_iter);
  } else {
    void* args[] = {(void*)&src,   (void*)&out,     (void*)&scratch,
                    (void*)&aff,   (void*)&valid,   (void*)&offsets,
                    (void*)&g,     (void*)&num_iter};
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads),
                                      args, smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

int launch_nc(int nc, const bf16* src, bf16* out, bf16* scratch,
              const bf16* aff, const int* valid, const int* offsets, Canvas g,
              int num_iter, cudaStream_t s) {
  switch (nc) {
#define EXCEL_PASS(N)                                                      \
  case N:                                                                  \
    return launch<N>(src, out, scratch, aff, valid, offsets, g, num_iter, \
                     s);
    EXCEL_PASS(1) EXCEL_PASS(2) EXCEL_PASS(3) EXCEL_PASS(4)
    EXCEL_PASS(5) EXCEL_PASS(6) EXCEL_PASS(7) EXCEL_PASS(8)
#undef EXCEL_PASS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int run(const bf16* src, const bf16* aff, const int* valid,
        const int* offsets, bf16* out, bf16* scratch, Canvas g, int num_iter,
        void* stream) {
  if (num_iter < 1 || g.B < 1 || g.C < 1 || g.h < 1 || g.w < 1 || g.K < 1 ||
      g.K > kMaxK || g.P < 0 || g.P > kMaxP || g.Hp < g.h + 2 * g.P ||
      g.Wp < g.w + 2 * g.P)
    return (int)cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // channels a pass: the fewest equal passes of at most 8 channels whose
  // shared memory fits (C=9: 5 + 4; C=7 at P=24: 4 + 3)
  for (int passes = (g.C + kMaxPass - 1) / kMaxPass; passes <= g.C;
       ++passes) {
    const int nc = (g.C + passes - 1) / passes;
    if (smem_bytes(nc, g.P) <= (size_t)limit)
      return launch_nc(nc, src, out, scratch, aff, valid, offsets, g,
                       num_iter, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// src, dst, out, scratch: [B, C, Hp, Wp] bf16 canvases (Hp >= h + 2P,
// Wp >= w + 2P, src replicate-valid-padded); aff: [B, K, h, w] bf16; valid:
// [B, 2] int32 (vh, vw); offsets: [K, 2] int32 (dy, dx) with |dy|, |dx| <=
// P <= 64 and K <= 128; all on the device, dst/out/scratch distinct from
// src. Returns a cudaError_t (0 on success).
extern "C" int excel_par_diffuse_valid_step_bf16(
    const bf16* src, const bf16* aff, const int* valid, const int* offsets,
    bf16* dst, int B, int C, int h, int w, int Hp, int Wp, int K, int P,
    void* stream) {
  return run(src, aff, valid, offsets, dst, dst,
             Canvas{B, C, h, w, Hp, Wp, K, P}, 1, stream);
}

extern "C" int excel_par_diffuse_valid_resident_bf16(
    const bf16* src, const bf16* aff, const int* valid, const int* offsets,
    bf16* out, bf16* scratch, int B, int C, int h, int w, int Hp, int Wp,
    int K, int P, int num_iter, void* stream) {
  return run(src, aff, valid, offsets, out, scratch,
             Canvas{B, C, h, w, Hp, Wp, K, P}, num_iter, stream);
}
