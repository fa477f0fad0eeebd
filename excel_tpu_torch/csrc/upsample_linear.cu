// Backward of the integer-factor linear upsample of the seg loss, fp32
// (ops/upsample_kernels.upsample_linear_backward).
//
// Replaces no Pallas kernel: the JAX package leaves the gradient of
// `jax.image.resize` to XLA. It replaces PyTorch's
// upsample_bilinear2d_backward, which scatters each output pixel's four
// weighted terms into the input gradient with atomicAdd: at factor 16 an
// input cell takes ~1,000 adds a plane from neighbouring threads of a warp,
// and the adds serialise (10.7% of the fast train step's card time).
//
// The forward (F.interpolate, bilinear, align_corners=False) samples output
// row y at src = max(h / H * (y + 0.5) - 0.5, 0): input rows y0 = (int)src
// and y1 = min(y0 + 1, h - 1) with weights 1 - l and l, l = src - y0;
// columns alike. The map is separable:
//
//   grad_in[p] = Wy^T . grad_out[p] . Wx,
//
// with two nonzeros in each row of Wy [H, h] and Wx [W, w]. Input row i
// gathers the output rows whose y0 is i - 1 or i: about 2 sy of them.
//
// Design: a gather. No atomics: each input cell is written once, by one
// warp, from sums taken in a fixed order, so two launches give the same
// bits. A block takes one plane, a band of kBand input rows and a tile of
// input columns (the whole row at the paths' widths). Its threads stream the
// output rows that the band gathers (the band's own and about sy / 2 more on
// each side, which the neighbouring bands read too, mostly from L2) with
// 16-byte loads where W % 4 == 0 and the gradient is 16-byte aligned, else
// 4-byte ones. A thread owns V columns and accumulates each row into the
// band's kBand rows in registers (the y reduction); the block splits the
// rows into `phases` of interleaved rows and leaves each phase's column sums
// in shared memory. Then a warp takes each input cell of the band: its lanes
// gather the cell's ~2 sx columns over the phases, and a butterfly of
// shuffles sums the lanes (the x reduction). The weights are computed as the
// forward computes them, in fp32.
//
// What bounds it: device memory. At the fast train step's
// [4, 21, 20, 20] -> [4, 21, 320, 320] it reads the 34.4 MB gradient once
// from device memory and writes 134 KB: 10.3 us at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 4;          // input rows a block
constexpr int kUnroll = 4;        // output rows a thread loads at once
constexpr int kMaxCols = 2048;    // output columns a tile stages at most
// floats of shared memory a block may take (48 KB, no opt-in needed)
constexpr int kMaxSmemFloats = 12288;

struct Taps {
  int i0, i1;
  float l0, l1;
};

// the two input taps of output index `o` and their weights, as PyTorch's
// upsample_bilinear2d computes them (area_pixel_compute_source_index)
__device__ __forceinline__ Taps taps(int o, int in, float scale) {
  const float src = fmaxf(scale * (o + 0.5f) - 0.5f, 0.f);
  Taps t;
  t.i0 = (int)src;
  t.i1 = t.i0 + (t.i0 < in - 1 ? 1 : 0);
  t.l1 = src - (float)t.i0;
  t.l0 = 1.f - t.l1;
  return t;
}

// the first output index whose first tap is at least k: 0 for k <= 0, `out`
// for k >= in. In exact arithmetic it is k s + s / 2 (integer division);
// fp32 rounding of the source position may move it by one.
__device__ int first_out(int k, int in, int out, float scale) {
  if (k <= 0) return 0;
  if (k >= in) return out;
  const int s = out / in;
  int o = k * s + s / 2;
  while (o > 0 && taps(o - 1, in, scale).i0 >= k) --o;
  while (o < out && taps(o, in, scale).i0 < k) ++o;
  return o;
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __ldg(p + e);
  }
}

// adds output row y's V values into the band's rows [i0, i0 + kBand)
template <int V>
__device__ __forceinline__ void accumulate(float (&acc)[kBand][V],
                                           const float (&v)[V], int y,
                                           int i0, int h, float scale) {
  const Taps t = taps(y, h, scale);
#pragma unroll
  for (int k = 0; k < kBand; ++k) {
    const float wk = (t.i0 - i0 == k ? t.l0 : 0.f) +
                     (t.i1 - i0 == k ? t.l1 : 0.f);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[k][e] = fmaf(wk, v[e], acc[k][e]);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    upsample_linear_bwd_kernel(const float* __restrict__ g,
                               float* __restrict__ gin, int h, int w, int H,
                               int W, int bands, int tiles, int tile_w) {
  extern __shared__ float sums[];  // [phases][kBand][cols]
  const int tile = blockIdx.x % tiles;
  const int band = (blockIdx.x / tiles) % bands;
  const size_t plane = blockIdx.x / (tiles * bands);
  // the forward's source scales, (float)in / out
  const float scy = (float)h / (float)H, scx = (float)w / (float)W;
  const int i0 = band * kBand, i1 = min(i0 + kBand, h);
  const int j0 = tile * tile_w, j1 = min(j0 + tile_w, w);
  const int ya = first_out(i0 - 1, h, H, scy);
  const int yb = first_out(i1, h, H, scy);
  const int xa = first_out(j0 - 1, w, W, scx) / V * V;
  const int xb = (first_out(j1, w, W, scx) + V - 1) / V * V;
  const int cols = xb - xa, nvec = cols / V;
  const int cthreads = min(nvec, kThreads), phases = kThreads / cthreads;
  const int phase = threadIdx.x / cthreads;
  const float* src = g + plane * H * W + xa;

  if (phase < phases) {
    for (int c = threadIdx.x % cthreads; c < nvec; c += cthreads) {
      float acc[kBand][V] = {};
      const float* p = src + c * V;
      int y = ya + phase;
      for (; y + (kUnroll - 1) * phases < yb; y += kUnroll * phases) {
        float v[kUnroll][V];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          load<V>(p + (size_t)(y + u * phases) * W, v[u]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          accumulate<V>(acc, v[u], y + u * phases, i0, h, scy);
      }
      for (; y < yb; y += phases) {
        float v[V];
        load<V>(p + (size_t)y * W, v);
        accumulate<V>(acc, v, y, i0, h, scy);
      }
#pragma unroll
      for (int k = 0; k < kBand; ++k)
#pragma unroll
        for (int e = 0; e < V; ++e)
          sums[(phase * kBand + k) * cols + c * V + e] = acc[k][e];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, nj = j1 - j0;
  for (int o = threadIdx.x >> 5; o < (i1 - i0) * nj; o += kThreads / 32) {
    const int k = o / nj, j = j0 + o % nj;
    const int xe = first_out(j + 1, w, W, scx);
    float acc = 0.f;
    for (int x = first_out(j - 1, w, W, scx) + lane; x < xe; x += 32) {
      const Taps t = taps(x, w, scx);
      const float wx = (t.i0 == j ? t.l0 : 0.f) + (t.i1 == j ? t.l1 : 0.f);
      float col = 0.f;
      for (int ph = 0; ph < phases; ++ph)
        col += sums[(ph * kBand + k) * cols + x - xa];
      acc = fmaf(wx, col, acc);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, d);
    if (lane == 0) gin[(plane * h + i0 + k) * w + j] = acc;
  }
}

template <int V>
int launch(const float* g, float* gin, int planes, int h, int w, int H,
           int W, cudaStream_t stream) {
  const int sx = W / w;
  // input columns a tile: the whole row where its output columns fit
  // kMaxCols, else as many as fit (at least one)
  int tile_w = w;
  if ((w + 1) * sx + 2 * V + 2 > kMaxCols)
    tile_w = max(1, (kMaxCols - 2 * V - 2) / sx - 1);
  const int tile_cols = (tile_w + 1) * sx + 2 * V + 2;
  const int floats = kBand * max(kThreads * V, tile_cols);
  const int bands = (h + kBand - 1) / kBand, tiles = (w + tile_w - 1) / tile_w;
  const long long blocks = (long long)planes * bands * tiles;
  if (floats > kMaxSmemFloats || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  upsample_linear_bwd_kernel<V>
      <<<(unsigned)blocks, kThreads, floats * sizeof(float), stream>>>(
          g, gin, h, w, H, W, bands, tiles, tile_w);
  return (int)cudaGetLastError();
}

}  // namespace

// grad_out: [planes, H, W] fp32, contiguous (any alignment); grad_in:
// [planes, h, w] fp32, contiguous, written whole; H = sy h and W = sx w for
// integer factors sy, sx >= 1 (sx up to 1,500: a tile's
// columns fit the 48 KB of shared memory); both on the device.
// Returns a cudaError_t (0 on success).
extern "C" int excel_upsample_linear_bwd_f32(const float* grad_out,
                                             float* grad_in, int planes,
                                             int h, int w, int H, int W,
                                             void* stream) {
  if (planes < 1 || h < 1 || w < 1 || H < h || W < w || H % h != 0 ||
      W % w != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (W % 4 == 0 && ((uintptr_t)grad_out & 15) == 0)
    return launch<4>(grad_out, grad_in, planes, h, w, H, W, s);
  return launch<1>(grad_out, grad_in, planes, h, w, H, W, s);
}
