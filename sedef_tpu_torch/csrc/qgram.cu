// The mesh step's q-gram gate: for each pair of code windows, the shared
// 5-gram count, the sum over the 1,024 bins of the smaller of the two
// windows' gram histograms (filter.cc:55-91).
//
// Replaces qgram_scores (sedef_tpu/parallel/mesh.py:46), a jit program of
// two segment-sum histograms; its plain PyTorch version is
// qgram_scores_torch in parallel/mesh.py (two scatter_add_ histograms of
// 1,024 bins and their minimum).  A gram is g = (g << 2) | c over QG
// codes, computed in uint32 and read as int32, as the plain version's
// int32 shift-or wraps; a gram outside [0, 1,024) (a code above 3) is
// dropped, as the plain version drops it.
//
// What bounds it on the H100: the bytes of the two windows (W bytes each)
// at a few operations a gram; the plain version's 1,024-bin histograms
// are (pairs, 1,024) int32 tensors written and read in device memory.
//
// What the design does about it: a block per pair, a's histogram in
// shared memory (4 KB) built with shared atomics; each of b's grams then
// takes one from its bin and counts a match where the count it found was
// positive.  A bin yields min(a's count, b's count) matches, so the sum
// is the histograms' intersection, with one histogram instead of two and
// no pass over the bins.

#include <cuda_runtime.h>

#include <cstdint>

#include "row_sort.cuh"

namespace {

constexpr int QG = 5;
constexpr uint32_t QSZ = 1u << (2 * QG);
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t gram(const uint8_t* c) {
  uint32_t g = 0;
#pragma unroll
  for (int j = 0; j < QG; ++j) g = (g << 2) | c[j];
  return g;  // as int32 in [0, QSZ) exactly when below QSZ unsigned
}

__global__ void __launch_bounds__(THREADS)
    qgram_kernel(const uint8_t* a, const uint8_t* b, int32_t* out, int W) {
  __shared__ int hist[QSZ];
  __shared__ int red[32];
  const long pair = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < static_cast<int>(QSZ); i += THREADS) hist[i] = 0;
  __syncthreads();
  const uint8_t* ca = a + pair * W;
  const uint8_t* cb = b + pair * W;
  const int n = W - QG + 1;
  for (int i = tid; i < n; i += THREADS) {
    const uint32_t g = gram(ca + i);
    if (g < QSZ) atomicAdd(&hist[g], 1);
  }
  __syncthreads();
  int count = 0;
  for (int i = tid; i < n; i += THREADS) {
    const uint32_t g = gram(cb + i);
    if (g < QSZ && atomicSub(&hist[g], 1) > 0) ++count;
  }
  count = group_sum<THREADS>(count, tid, red);
  if (tid == 0) out[pair] = count;
}

}  // namespace

extern "C" {

// P pairs of (W,) uint8 code windows, a and b (P, W) contiguous: writes
// out (P,) int32, the shared QG-gram count of each pair (0 where W < QG).
// Launches on ``stream`` without synchronising; returns a CUDA error code.
int sedef_qgram_scores(const void* a, const void* b, void* out, int P, int W,
                       void* stream) {
  if (P < 0 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaGetLastError());
  qgram_kernel<<<static_cast<unsigned>(P), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<int32_t*>(out), W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
