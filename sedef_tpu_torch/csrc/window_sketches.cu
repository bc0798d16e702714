// The roll prefilter's query-window sketches: for each interval row, the
// sorted distinct keys of its query window, their count, the relaxed
// Jaccard limit at that count and whether the window overflowed.
//
// Replaces _window_sketches (sedef_tpu/ops/prefilter.py:73), a jit
// program; its plain PyTorch version is _window_sketches_torch in
// ops/prefilter.py (two row sorts of (B, SQ) with a dedup between them).
// Per row b: the keys q_keys[qws .. min(qwe, qws + SQ)) (the first SQ of
// an overflowing window, not its SQ smallest; an index past the keys
// reads the last one, as the plain version's clamped gather does), sorted
// ascending, each key equal to its left neighbour dropped, then INF32
// padding to SQ; s = the keys kept, limit = lut[min(s, n_lut - 1)], ovf =
// qwe - qws > SQ.  Plan indices are never negative; 0 keeps a stray one
// in bounds.
//
// What bounds it on the H100: the bytes, a row's gathered keys (~80 of
// its 160 at the prefilter's windows) and its SQ-wide output row, read and
// written once; the sort is n log2 n comparisons of those ~80 keys.  The
// plain version sorts the SQ-wide padded row twice.
//
// What the design does about it: a warp per row (eight a block), the
// gathered keys in shared memory, bitonic-sorted over the next power of
// two above the gathered count (not SQ: most rows sort 128 entries), and
// the dedup and the second sort become one compaction: a key is kept when
// it differs from its left neighbour, its place is a ballot and a popc of
// the lanes below it, so the distinct keys land in order with no second
// sort.  All four outputs are written in the same launch.  The row code
// (``warp_sketch``) is csrc/window_rows.cuh's, which the per-interval
// kernel csrc/prefilter_intervals.cu runs too.

#include <cuda_runtime.h>

#include <cstdint>

#include "window_rows.cuh"

namespace {

constexpr int ROWS = 8;  // rows a block, a warp each

struct SketchArgs {
  const int32_t* q_keys;
  const int32_t* qws;
  const int32_t* qwe;
  const int32_t* lut;
  int32_t* qk;     // (B, SQ)
  int32_t* s;      // (B,)
  int32_t* limit;  // (B,)
  uint8_t* ovf;    // (B,)
  int B, n_q, n_lut, SQ, SQP;
};

__global__ void __launch_bounds__(ROWS * 32)
    window_sketches_kernel(SketchArgs a) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long row = static_cast<long>(blockIdx.x) * ROWS + warp;
  if (row >= a.B) return;  // a whole warp
  int32_t* x = smem + warp * a.SQP;

  const int qws = a.qws[row], qwe = a.qwe[row];
  const int s = warp_sketch(a.q_keys, a.n_q, qws, qwe, a.SQ, x,
                            a.qk + row * a.SQ, lane);
  if (lane == 0) {
    a.s[row] = s;
    a.limit[row] = a.lut[s < a.n_lut - 1 ? s : a.n_lut - 1];
    a.ovf[row] = static_cast<long>(qwe) - qws > a.SQ;
  }
}

}  // namespace

extern "C" {

// B rows of query-window sketches.  q_keys (n_q,) int32; qws, qwe (B,)
// int32 each row's query window [qws, qwe); lut (n_lut,) int32 the relaxed
// limits by sketch size.  Writes qk (B, SQ) int32 ascending distinct keys,
// INF32-padded; s, limit (B,) int32; ovf (B,) bool.  SQ <= 1,024.
// Launches on ``stream`` without synchronising; returns a CUDA error code.
int sedef_window_sketches(const void* q_keys, const void* qws,
                          const void* qwe, const void* lut, void* qk,
                          void* s, void* limit, void* ovf, int B, int n_q,
                          int n_lut, int SQ, void* stream) {
  if (n_q < 1 || n_lut < 1 || SQ < 1 || SQ > 1024 || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  int SQP = 2;
  while (SQP < SQ) SQP <<= 1;
  const SketchArgs p = {static_cast<const int32_t*>(q_keys),
                        static_cast<const int32_t*>(qws),
                        static_cast<const int32_t*>(qwe),
                        static_cast<const int32_t*>(lut),
                        static_cast<int32_t*>(qk),
                        static_cast<int32_t*>(s),
                        static_cast<int32_t*>(limit),
                        static_cast<uint8_t*>(ovf),
                        B, n_q, n_lut, SQ, SQP};
  const size_t smem = sizeof(int32_t) * ROWS * static_cast<size_t>(SQP);
  const long blocks = (static_cast<long>(B) + ROWS - 1) / ROWS;
  window_sketches_kernel<<<static_cast<unsigned>(blocks), ROWS * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
