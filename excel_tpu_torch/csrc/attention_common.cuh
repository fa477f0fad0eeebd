// Shared pieces of the attention kernels (attention_plain.cu,
// attention_surgery.cu; the fp32 kernels of attention_fma.cuh and the bf16
// tensor-core kernels of attention_mma.cuh).
//
// Both types run the same two kernels, each with 128 threads (but the bf16
// surgery sums kernel, with 256: attention_mma.cuh):
//
//   rows kernel   one block = 64 query rows of one (image, head). The
//                 softmax is the exact one over the whole row in two passes
//                 over the keys, 64 at a time: pass 1 forms the logits and
//                 keeps, per thread, a running maximum and a rescaled sum of
//                 exponentials of its own columns (combined across the
//                 threads of a row once, by shuffles); pass 2 forms the same
//                 logits again (same instructions, same bits), turns them
//                 into the NORMALISED p = 2^(x c - m c) / s, c = D^-1/2
//                 log2(e), rounds p to the element type and multiplies it
//                 with V. No [TQ, N] row buffer and no [N, N] matrix of a
//                 head exists anywhere. When head sums are wanted it also
//                 writes each row's statistics (m c, 1 / s) of each softmax
//                 (one for plain attention; four for surgery: q k^T, q q^T,
//                 k k^T, v v^T; the k k^T and v v^T rows use rows of k and
//                 v as their queries) into an fp32 scratch [B, H, N, P, 2].
//   sums kernel   one block = a 64 x 64 patch of the [N, N] head sums of one
//                 image. Loops over the heads: forms the patch's logits
//                 again, p from the row statistics, and adds every term of
//                 every head in REGISTERS: a fixed thread owns a fixed
//                 element and takes the heads in order, so a launch gives
//                 the same bits every time without atomics or barriers
//                 around the sums. The patch is written once (mode acc reads
//                 the accumulator once; ex is read once). ceil(N/64)^2 x B
//                 blocks: 196 at the train step's B=4, N=401. In bf16, warps
//                 whose rows or keys lie wholly beyond N form nothing, so
//                 the ragged last row and column of patches cost little.
//
// The TPU kernels carried the head sums across a sequential grid axis and
// kept a head's [rows, N] logits in VMEM; here the products are cheap
// enough (tensor cores) or tile well enough (10 FMA a 16-byte shared-memory
// load) to form the logits twice or three times instead, which frees the
// shared memory for larger tiles and more blocks an SM.
//
// Copies are 16-byte `cp.async` with zero fill for rows >= N into a two-stage
// ring (the bf16 sums kernel's: the copy engine's, TMA): the next chunk or
// the next head's tiles load while the current ones are multiplied. Padded
// keys are masked to -inf before the softmax; padded V rows are zero (0 x
// garbage would be NaN).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace excel {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // query rows a block; keys a chunk or patch

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled when !valid (src must still be a
// mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Wait for the copies of the current step: all but the newest group when a
// further step has been started.
__device__ __forceinline__ void cp_async_wait_step(bool more_pending) {
  if (more_pending) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

// One running-softmax step for a thread's own columns of one row: (m, s)
// are the maximum of the raw logits seen so far and sum 2^((x - m) c);
// mx is that maximum including the new logits. Rescales s, sets m = mx and
// returns m c for the new exponents.
__device__ __forceinline__ float stat_rescale(float& m, float& s, float mx,
                                              float c) {
  // every column so far masked: keep the exponents finite
  const float ms = mx == -INFINITY ? 0.f : mx;
  s *= exp2f((m - ms) * c);
  m = mx;
  return ms * c;
}

// Combine the kLanes neighbouring lanes that share a row (a power of two):
// afterwards m holds m c and s holds 1 / sum, the same in all of them, the
// sums taken in the same order on every lane.
template <int kLanes>
__device__ __forceinline__ void stat_combine(float& m, float& s, float c) {
  float mx = m;
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = s * exp2f((m - mx) * c);
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  m = mx * c;
  s = 1.f / sum;
}

// log2(e) / sqrt(D): the logits' scale in the base-2 exponent
inline float scale_log2e(int d) {
  return (float)(1.4426950408889634 / sqrt((double)d));
}

}  // namespace excel
