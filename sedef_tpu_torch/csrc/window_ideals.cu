// The roll prefilter's window ideals: for each row, the keys of a
// contiguous minimizer range [a, b) of the reference (HAS_N keys dropped)
// against a sorted distinct query row, counting the shared keys whose rank
// in the distinct union is below s.
//
// Replaces two jit programs of sedef_tpu/ops/prefilter.py, one kernel for
// both (their plain PyTorch versions are the *_torch functions of
// ops/prefilter.py, which call merge_rank_intersection):
//   _composition_ideals (:118)   width RW (192), the query row gathered by
//                                iv_id, s the row's rank limit
//   _span_intersections (:92)    width SA (1,024), the query row aligned
//                                with the row, s = SQ + SA (no limit)
// A row whose range is wider than the width gets INF32 (no bound).  The
// count is merge_rank_intersection's (ops/jaccard_batch.py:33-69):
// distinct union ranks, duplicate ref keys collapsed, INF never counted.
//
// What bounds it on the H100: the sort of each row's keys (n log2 n
// compare-exchanges over up to the width) and the ranks; the bytes are a
// row's keys and its query row (~1.4 KB at RW 192), read once.  The plain
// version materialises an (N, SQ + width) tagged concat and sorts it: 184
// MB of int32 at 131,072 composition rows.
//
// What the design does about it: the concat never exists.  A row's keys
// are loaded coalesced into shared memory and sorted there by a bitonic
// sort over the next power of two above the range (not the width: a
// composition row holds ~80 keys of its 192); the query row goes beside
// them.  Each distinct ref key then finds its place in the query row by a
// binary search, which gives the query keys below it and whether it is
// shared; an exclusive scan over the ref-only distinct keys gives the rest
// of its union rank, and the shared keys of rank < s are summed.  A warp
// per row at width <= 256 (four rows a block), a block of 256 threads per
// row up to 1,024, 512 up to 4,096.  The rank arithmetic (``rank_count``)
// is csrc/window_rows.cuh's, which the per-interval kernel
// csrc/prefilter_intervals.cu runs on its composition rows too.

#include <cuda_runtime.h>

#include <cstdint>

#include "window_rows.cuh"

namespace {

struct IdealArgs {
  const int32_t* r_keys;
  const int32_t* qk;     // (n_qrows, SQ) sorted distinct, INF-padded
  const int32_t* s;      // (n_qrows,) rank limits, or null: s_const
  const int32_t* a;      // (N,) range starts
  const int32_t* b;      // (N,) range ends
  const int32_t* iv;     // (N,) query row of each row, or null: the row
  int32_t* out;          // (N,)
  int N, n_rk, SQ, width, s_const, n_shift;
};

// PAD: a power of two >= the width; THREADS a row (32: a warp, and
// ROWS = blockDim / 32 rows a block; else the block is one row)
template <int PAD, int THREADS>
__global__ void window_ideals_kernel(IdealArgs p) {
  extern __shared__ int32_t smem[];
  __shared__ int red[32];
  const int tid = threadIdx.x % THREADS;
  const int g = threadIdx.x / THREADS;
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x / THREADS) + g;
  if (row >= p.N) return;  // a whole warp, or a whole one-row block
  int32_t* keys = smem + g * (PAD + p.SQ);
  int32_t* q = keys + PAD;

  const int a = p.a[row], b = p.b[row];
  if (b - a > p.width) {
    if (tid == 0) p.out[row] = INF32;
    return;
  }
  const int n = b - a > 0 ? b - a : 0;
  int n2 = 2;
  while (n2 < n) n2 <<= 1;
  for (int j = tid; j < n2; j += THREADS) {
    int32_t v = INF32;
    if (j < n) {
      const int i = a + j < p.n_rk ? a + j : p.n_rk - 1;
      v = sketch_key(p.r_keys[i < 0 ? 0 : i], p.n_shift);
    }
    keys[j] = v;
  }
  const long qrow = p.iv ? p.iv[row] : row;
  const int32_t* qsrc = p.qk + qrow * p.SQ;
  for (int j = tid; j < p.SQ; j += THREADS) q[j] = qsrc[j];
  const int s = p.s ? p.s[qrow] : p.s_const;
  group_sync<THREADS>();
  group_bitonic<THREADS>(keys, n2, tid);

  const int count =
      rank_count<PAD, THREADS>(keys, n2, q, p.SQ, s, tid, red);
  if (tid == 0) p.out[row] = count;
}

template <int PAD, int THREADS>
int launch(const IdealArgs& p, cudaStream_t stream) {
  const int rows = THREADS == 32 ? 4 : 1;
  const size_t smem = sizeof(int32_t) * rows * (size_t)(PAD + p.SQ);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_ideals_kernel<PAD, THREADS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long blocks = (p.N + rows - 1) / rows;
  window_ideals_kernel<PAD, THREADS>
      <<<static_cast<unsigned>(blocks), rows * THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// N rows of window ideals.  r_keys (n_rk,) int32; qk (*, SQ) int32 sorted
// distinct and INF-padded; a, b (N,) int32 each row's [a, b) minimizer
// range; iv (N,) int32 each row's query row, or null for row i's own; s
// (*,) int32 the query rows' rank limits, or null for s_const.  Writes out
// (N,) int32: the count, or INF32 where b - a > width (width <= 4,096).
// Launches on ``stream`` without synchronising; returns a CUDA error code.
int sedef_window_ideals(const void* r_keys, const void* qk, const void* s,
                        const void* a, const void* b, const void* iv,
                        void* out, int N, int n_rk, int SQ, int width,
                        int s_const, int n_shift, void* stream) {
  if (n_rk < 1 || SQ < 1 || width < 1 || width > 4096 || n_shift < 0 ||
      n_shift > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  const IdealArgs p = {static_cast<const int32_t*>(r_keys),
                       static_cast<const int32_t*>(qk),
                       static_cast<const int32_t*>(s),
                       static_cast<const int32_t*>(a),
                       static_cast<const int32_t*>(b),
                       static_cast<const int32_t*>(iv),
                       static_cast<int32_t*>(out),
                       N, n_rk, SQ, width, s_const, n_shift};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width <= 256) return launch<256, 32>(p, st);
  if (width <= 1024) return launch<1024, 256>(p, st);
  return launch<4096, 512>(p, st);
}

}  // extern "C"
