// Row primitives of stage 1's kernels, for a group of threads that is
// either one warp (THREADS 32) or a whole block: a barrier, a sum, an
// exclusive prefix sum in thread order, and an ascending bitonic sort of a
// row in shared memory.  Included by csrc/window_rows.cuh (and so by
// csrc/prefilter_intervals.cu), csrc/roll_engine.cu, csrc/device_index.cu
// and csrc/qgram.cu; each of them gets its own copy (an unnamed namespace).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int32_t INF32 = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

template <int THREADS>
__device__ __forceinline__ void group_sync() {
  if (THREADS == 32)
    __syncwarp();
  else
    __syncthreads();
}

// the group's sum of v (every thread of the group gets it); red holds 32
// ints of shared memory when the group is a whole block
template <int THREADS>
__device__ int group_sum(int v, int tid, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if (THREADS == 32) return v;
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

// the group's exclusive prefix sum of v, in thread order
template <int THREADS>
__device__ int group_exclusive(int v, int tid, int* red) {
  const int lane = tid & 31;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += u;
  }
  if (THREADS == 32) return inc - v;
  if (lane == 31) red[tid >> 5] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < (tid >> 5); ++w) before += red[w];
  __syncthreads();
  return before + inc - v;
}

// ascending bitonic sort of x[0, n), n a power of two, by the group
template <int THREADS>
__device__ void group_bitonic(int32_t* x, int n, int tid) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n / 2; i += THREADS) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const int32_t u = x[lo], v = x[hi];
        if ((u > v) == ((lo & k) == 0)) {
          x[lo] = v;
          x[hi] = u;
        }
      }
      group_sync<THREADS>();
    }
  }
}

}  // namespace
