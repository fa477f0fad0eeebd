// PAR diffusion on a bf16 padded canvas with the per-image valid-extent
// clamp fused in: one step (row 7), or all steps in one cooperative launch
// (row 9).
//
// Replaces the TPU kernels excel_tpu/ops/par_pallas.py
// `_diffuse_padded_valid_kernel` (:342, called by par_diffuse_padded_valid)
// and `_diffuse_resident_kernel` (:654, called by
// par_diffuse_valid_resident). The canvas is [B, C, Hp, Wp] with the image
// at rows/columns [P, P + h) x [P, P + w) and (vh, vw) = valid_hw[b]. A step
//
//   acc[c, y, x] = sum over chunks of 8 offsets of
//                  (sum over the chunk of float(bf16(aff[k, y, x] *
//                   m[c, y + P + dy_k, x + P + dx_k])))
//   out[c, Y, X] = bf16(acc[c, clamp(Y - P, 0, vh - 1),
//                           clamp(X - P, 0, vw - 1)])
//
// for every canvas position (Y, X), slack included: each product is
// rounded once to bf16 (the TPU's `(a * m).astype(f32)`),
// then summed in fp32 within a chunk left to right and chunk by chunk, as
// par_pallas._accumulate_offsets does. The TPU kernel writes the rows >= vh
// from a border row that it carries from tile to tile in VMEM; GPU blocks
// cannot wait for one another within a step, so here the block of each
// tile computes the sums of its positions' clamped valid source pixels
// itself, and no block depends on another within a step. The TPU kernel's
// border is that same value (a one-hot sum of one number), so the two agree
// bit for bit.
//
// What bounds it: device memory. At the fast path's shapes (B=16, C=4,
// K=48, 384x512 in a 440x640 canvas, bf16) the affinities are 302 MB per
// step and the canvas adds 36 MB in and out. Design: one block owns a tile
// of kTH x kTW canvas positions. Their clamped sources form one rectangle
// of at most kTH x kTW valid pixels (one row or column for tiles in the pad
// or beyond the extent); the block stages that rectangle's masks with their
// P-pixel halo in shared memory, computes each source pixel's K-term sums
// once (reading each affinity once, for all the channels of a group), keeps
// them in shared memory, and writes every position of its tile from them.
// Channels go in groups of kGroup = 4, staged side by side, so one 8-byte
// shared load brings a neighbour's 4 channels and two packed bf16 products
// (__hmul2) give their 4 rounded terms. A first version read the
// neighbours from L1/L2 and had every position recompute its source's sum:
// 1.26 ms a step (PERF.md).
//
// The resident entry point runs `num_iter` steps in one cooperative launch
// (cudaLaunchCooperativeKernel): persistent blocks, as many as fit on the
// card at once, walk the tiles in a grid-stride loop, and
// cooperative_groups::this_grid().sync() separates the steps, which
// ping-pong between the output and a scratch canvas (the input is never
// written). That is the GPU reading of the TPU's VMEM-resident canvas: one
// launch and no host loop. No atomics: every run gives the same bits, and
// the same bits as `num_iter` launches of the step entry point.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8;      // canvas rows per tile
constexpr int kTW = 128;    // canvas columns per tile
constexpr int kGroup = 4;   // channels staged together, interleaved
constexpr int kChunk = 8;   // offsets per fp32 partial sum, as on the TPU
constexpr int kMaxK = 64;   // offsets the shared table holds
constexpr int kLaneCols = 8;  // staged row width up to 32 * 8 = kTW + 2P

struct Canvas {
  int B, C, h, w, Hp, Wp, K, P;
};

using bf16 = __nv_bfloat16;

// A neighbour's kGroup = 4 channels, staged next to each other (one 8-byte
// word), and their products with one affinity, each rounded once to bf16
// and returned as fp32. A product of two bf16 values is exact in fp32, so
// __hmul2_rn's one rounding equals rounding the fp32 product.
__device__ inline uint2 pack(const bf16* v) {
  __nv_bfloat162 lo = __halves2bfloat162(v[0], v[1]);
  __nv_bfloat162 hi = __halves2bfloat162(v[2], v[3]);
  return make_uint2(*reinterpret_cast<unsigned*>(&lo),
                    *reinterpret_cast<unsigned*>(&hi));
}

__device__ inline void terms(bf16 a, uint2 m, float* t) {
  const __nv_bfloat162 a2 = __bfloat162bfloat162(a);
  const __nv_bfloat162 p01 =
      __hmul2_rn(a2, *reinterpret_cast<const __nv_bfloat162*>(&m.x));
  const __nv_bfloat162 p23 =
      __hmul2_rn(a2, *reinterpret_cast<const __nv_bfloat162*>(&m.y));
  t[0] = __low2float(p01);
  t[1] = __high2float(p01);
  t[2] = __low2float(p23);
  t[3] = __high2float(p23);
}

// Shared memory of one block: the offset table, the staged haloed masks of
// a channel group (kGroup channels interleaved), and the group's sums of
// the tile's source pixels.
size_t smem_bytes(int P) {
  return kMaxK * sizeof(int) +
         kGroup * ((size_t)(kTH + 2 * P) * (kTW + 2 * P) + kTH * kTW) *
             sizeof(bf16);
}

// One step of tile `tile` from src to dst. src is read with ordinary
// (coherent) loads: in the resident kernel it was written by other blocks
// before the last grid barrier.
__device__ void step_tile(const bf16* src, bf16* dst,
                          const bf16* __restrict__ aff,
                          const int* __restrict__ valid,
                          const int* __restrict__ offsets, const Canvas g,
                          int tile, unsigned char* smem) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tiles_x = (g.Wp + kTW - 1) / kTW;
  const int tiles_y = (g.Hp + kTH - 1) / kTH;
  const int b = tile / (tiles_x * tiles_y);
  const int Y0 = (tile / tiles_x) % tiles_y * kTH;
  const int X0 = tile % tiles_x * kTW;
  const int vh = min(max(__ldg(valid + 2 * b), 1), g.h);
  const int vw = min(max(__ldg(valid + 2 * b + 1), 1), g.w);
  // the rectangle of source pixels of the tile's positions
  const int sy0 = min(max(Y0 - g.P, 0), vh - 1);
  const int sy1 = min(max(min(Y0 + kTH, g.Hp) - 1 - g.P, 0), vh - 1);
  const int sx0 = min(max(X0 - g.P, 0), vw - 1);
  const int sx1 = min(max(min(X0 + kTW, g.Wp) - 1 - g.P, 0), vw - 1);
  const int rh = sy1 - sy0 + 1, rw = sx1 - sx0 + 1;
  const int sh = rh + 2 * g.P, sw = rw + 2 * g.P;  // staged, with halo

  int* delta = reinterpret_cast<int*>(smem);  // offset k -> staged offset
  uint2* stage = reinterpret_cast<uint2*>(smem + kMaxK * sizeof(int));
  bf16* sums = reinterpret_cast<bf16*>(stage + (size_t)(kTH + 2 * g.P) *
                                                   (kTW + 2 * g.P));
  const size_t plane = (size_t)g.Hp * g.Wp;
  const size_t hw = (size_t)g.h * g.w;

  __syncthreads();  // the previous tile's readers of smem are done
  for (int k = threadIdx.x; k < g.K; k += kThreads)
    delta[k] = __ldg(offsets + 2 * k) * sw + __ldg(offsets + 2 * k + 1);

  for (int c0 = 0; c0 < g.C; c0 += kGroup) {
    const int nc = min(kGroup, g.C - c0);
    if (c0 > 0) __syncthreads();  // the last group's readers are done
    // stage rows [sy0, sy1 + 2P] x cols [sx0, sx1 + 2P] of the canvas (the
    // sources' neighbours, all inside [0, h + 2P) x [0, w + 2P)), the
    // group's channels side by side (missing ones as 0): a warp a row,
    // lanes along it, all of a row's loads issued before its stores
    const bf16* s0 = src + ((size_t)b * g.C + c0) * plane +
                     (size_t)sy0 * g.Wp + sx0;
    for (int row = warp; row < sh; row += kWarps) {
      const bf16* from = s0 + (size_t)row * g.Wp;
      bf16 v[kLaneCols][kGroup];
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
#pragma unroll
        for (int c = 0; c < kGroup; ++c)
          v[j][c] = lane + 32 * j < sw && c < nc
                        ? from[c * plane + lane + 32 * j]
                        : __float2bfloat16_rn(0.f);
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j)
        if (lane + 32 * j < sw)
          stage[(size_t)row * sw + lane + 32 * j] = pack(v[j]);
    }
    __syncthreads();
    // each source pixel's sums for the group's channels; a chunk's
    // affinities are loaded together, so their latencies overlap
    for (int p = threadIdx.x; p < rh * rw; p += kThreads) {
      const int ry = p / rw, rx = p - ry * rw;
      const bf16* a = aff + (size_t)b * g.K * hw +
                      (size_t)(sy0 + ry) * g.w + sx0 + rx;
      const uint2* m = stage + (ry + g.P) * sw + rx + g.P;
      float acc[kGroup], part[kGroup];
      for (int k0 = 0; k0 < g.K; k0 += kChunk) {
        bf16 av[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (k0 + j < g.K) av[j] = a[(size_t)(k0 + j) * hw];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (k0 + j >= g.K) break;
          float t[kGroup];
          terms(av[j], m[delta[k0 + j]], t);
#pragma unroll
          for (int c = 0; c < kGroup; ++c)
            part[c] = j == 0 ? t[c] : __fadd_rn(part[c], t[c]);
        }
#pragma unroll
        for (int c = 0; c < kGroup; ++c)
          acc[c] = k0 == 0 ? part[c] : __fadd_rn(acc[c], part[c]);
      }
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        if (c < nc)
          sums[(c * kTH + ry) * kTW + rx] = __float2bfloat16_rn(acc[c]);
    }
    __syncthreads();
    // every position of the tile takes its source pixel's sum; a warp a
    // row, lanes along the row
    bf16* d0 = dst + ((size_t)b * g.C + c0) * plane;
    for (int row = warp; row < nc * kTH; row += kWarps) {
      const int c = row / kTH;
      const int Y = Y0 + row - c * kTH;
      if (Y >= g.Hp) continue;
      const bf16* from =
          sums + (c * kTH + min(max(Y - g.P, 0), vh - 1) - sy0) * kTW;
      bf16* to = d0 + c * plane + (size_t)Y * g.Wp;
      for (int X = X0 + lane; X < min(X0 + kTW, g.Wp); X += 32)
        to[X] = from[min(max(X - g.P, 0), vw - 1) - sx0];
    }
  }
}

__host__ __device__ inline int num_tiles(const Canvas& g) {
  return g.B * ((g.Hp + kTH - 1) / kTH) * ((g.Wp + kTW - 1) / kTW);
}

__global__ void __launch_bounds__(kThreads, 2)
    step_kernel(const bf16* src, bf16* dst, const bf16* __restrict__ aff,
                const int* __restrict__ valid,
                const int* __restrict__ offsets, Canvas g) {
  extern __shared__ __align__(16) unsigned char smem[];
  step_tile(src, dst, aff, valid, offsets, g, blockIdx.x, smem);
}

__global__ void __launch_bounds__(kThreads, 2)
    resident_kernel(const bf16* src, bf16* out, bf16* scratch,
                    const bf16* __restrict__ aff,
                    const int* __restrict__ valid,
                    const int* __restrict__ offsets, Canvas g,
                    int num_iter) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int tiles = num_tiles(g);
  const bf16* s = src;
  for (int it = 0; it < num_iter; ++it) {
    // the last step lands in `out`
    bf16* d = ((num_iter - 1 - it) & 1) ? scratch : out;
    if (it > 0) grid.sync();  // step it-1 is written, its reads are done
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
      step_tile(s, d, aff, valid, offsets, g, tile, smem);
    s = d;
  }
}

cudaError_t prepare(const Canvas& g, size_t* smem, const void* kernel) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *smem = smem_bytes(g.P);
  if (g.K > kMaxK || kTW + 2 * g.P > 32 * kLaneCols ||
      g.Hp < g.h + 2 * g.P || g.Wp < g.w + 2 * g.P || *smem > (size_t)limit)
    return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

int step(const bf16* src, const bf16* aff, const int* valid,
         const int* offsets, bf16* dst, Canvas g, void* stream) {
  size_t smem = 0;
  cudaError_t err = prepare(g, &smem, (const void*)step_kernel);
  if (err != cudaSuccess) return (int)err;
  step_kernel<<<num_tiles(g), kThreads, smem, (cudaStream_t)stream>>>(
      src, dst, aff, valid, offsets, g);
  return (int)cudaGetLastError();
}

int resident(const bf16* src, const bf16* aff, const int* valid,
             const int* offsets, bf16* out, bf16* scratch, Canvas g,
             int num_iter, void* stream) {
  if (num_iter < 1) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t err = prepare(g, &smem, (const void*)resident_kernel);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, resident_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int fit = per_sm * sms;
  const int blocks = fit < num_tiles(g) ? fit : num_tiles(g);
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&src,     (void*)&out,   (void*)&scratch,
                  (void*)&aff,     (void*)&valid, (void*)&offsets,
                  (void*)&g,       (void*)&num_iter};
  err = cudaLaunchCooperativeKernel((const void*)resident_kernel,
                                    dim3(blocks), dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// src, dst, out, scratch: [B, C, Hp, Wp] bf16 canvases (Hp >= h + 2P,
// Wp >= w + 2P, src replicate-valid-padded); aff: [B, K, h, w] bf16; valid:
// [B, 2] int32 (vh, vw); offsets: [K, 2] int32 (dy, dx) with |dy|, |dx| <=
// P <= 64 and K <= 64; all on the device, dst/out/scratch distinct from
// src. Returns a cudaError_t (0 on success).
extern "C" int excel_par_diffuse_valid_step_bf16(
    const bf16* src, const bf16* aff, const int* valid, const int* offsets,
    bf16* dst, int B, int C, int h, int w, int Hp, int Wp, int K, int P,
    void* stream) {
  return step(src, aff, valid, offsets, dst, Canvas{B, C, h, w, Hp, Wp, K, P},
              stream);
}

extern "C" int excel_par_diffuse_valid_resident_bf16(
    const bf16* src, const bf16* aff, const int* valid, const int* offsets,
    bf16* out, bf16* scratch, int B, int C, int h, int w, int Hp, int Wp,
    int K, int P, int num_iter, void* stream) {
  return resident(src, aff, valid, offsets, out, scratch,
                  Canvas{B, C, h, w, Hp, Wp, K, P}, num_iter, stream);
}
