// Row code of the roll prefilter's kernel: a query window's sketch built
// by one warp, the ideal count of a sorted window row against a sketch,
// and a warp's lower bound over sorted loci.  Included by
// csrc/prefilter_intervals.cu (an interval a block).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "row_sort.cuh"

namespace {

// HAS_N ref keys are never added to the sketch (sliding.cc:158-168)
__device__ __forceinline__ int32_t sketch_key(int32_t v, int n_shift) {
  return (v >> n_shift) == 2 ? INF32 : v;
}

// The sketch of the query window [qws, qwe), built by one warp: the keys
// q_keys[qws .. min(qwe, qws + SQ)) (the first SQ of an overflowing window;
// an index past the keys reads the last one, a negative one the first),
// sorted ascending in x (scratch of a power of two >= SQ entries), each key
// equal to its left neighbour dropped and the rest written in order to
// out[0, s), INF32 after them up to SQ.  Returns s (every lane).
__device__ int warp_sketch(const int32_t* q_keys, int n_q, int qws, int qwe,
                           int SQ, int32_t* x, int32_t* out, int lane) {
  const long span = static_cast<long>(qwe) - qws;
  const int n = span <= 0 ? 0 : (span < SQ ? static_cast<int>(span) : SQ);
  int n2 = 2;
  while (n2 < n) n2 <<= 1;
  for (int j = lane; j < n2; j += 32) {
    int32_t v = INF32;
    if (j < n) {
      const int i = qws + j < n_q ? qws + j : n_q - 1;
      v = q_keys[i < 0 ? 0 : i];
    }
    x[j] = v;
  }
  __syncwarp();
  group_bitonic<32>(x, n2, lane);

  // the distinct keys in order: kept where not INF and not equal to the
  // key on the left; a kept key's slot is the kept keys before it
  int s = 0;
  for (int base = 0; base < n2; base += 32) {
    const int j = base + lane;
    const int32_t v = j < n2 ? x[j] : INF32;
    const bool keep = v != INF32 && (j == 0 || x[j - 1] != v);
    const unsigned m = __ballot_sync(FULL, keep);
    if (keep) out[s + __popc(m & ((1u << lane) - 1))] = v;
    s += __popc(m);
  }
  for (int j = s + lane; j < SQ; j += 32) out[j] = INF32;
  __syncwarp();
  return s;
}

// The ideal count of one sorted window row: keys[0, n2) ascending and
// INF-padded (duplicates allowed), q[0, SQ) sorted distinct and
// INF-padded; the shared distinct keys whose rank in the distinct union is
// below s (merge_rank_intersection, ops/jaccard_batch.py:33-69).  For the
// group of THREADS threads (a warp, or a whole block); PAD >= n2, a power
// of two.  Every thread of the group gets the count.
//
// Each distinct ref key finds its place in the query row by a binary
// search, which gives the query keys below it and whether it is shared;
// an exclusive scan over the ref-only distinct keys gives the rest of its
// union rank.
template <int PAD, int THREADS>
__device__ int rank_count(const int32_t* keys, int n2, const int32_t* q,
                          int SQ, int s, int tid, int* red) {
  constexpr int E = PAD / THREADS;  // sorted entries a thread scans
  int lq[E];
  unsigned shared_mask = 0;
  int ref_only = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = tid * E + e;
    lq[e] = 0;
    if (j >= n2) continue;
    const int32_t k = keys[j];
    if (k == INF32 || (j > 0 && keys[j - 1] == k)) continue;
    int lo = 0, hi = SQ;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (q[mid] < k)
        lo = mid + 1;
      else
        hi = mid;
    }
    lq[e] = lo;
    if (lo < SQ && q[lo] == k)
      shared_mask |= 1u << e;
    else
      ref_only += 1;
  }
  // union rank of a shared key = query keys below it + ref-only distinct
  // keys below it
  int before = group_exclusive<THREADS>(ref_only, tid, red);
  int count = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = tid * E + e;
    if (j >= n2) continue;
    const int32_t k = keys[j];
    if (k == INF32 || (j > 0 && keys[j - 1] == k)) continue;
    if (shared_mask & (1u << e))
      count += lq[e] + before < s;
    else
      before += 1;
  }
  return group_sum<THREADS>(count, tid, red);
}

// The first index of locs[lo, hi) (ascending) whose value is >= x, or hi,
// found by one warp: each round the 32 lanes probe 32 evenly spaced
// entries and a ballot keeps the gap the answer lies in (five rounds over
// ten million loci).  Every lane gets it.
__device__ int warp_lower_bound(const int32_t* locs, int lo, int hi,
                                long long x, int lane) {
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool less = p < hi && static_cast<long long>(locs[p]) < x;
    const int c = __popc(__ballot_sync(FULL, less));
    // probes 0 .. c-1 are below x: the answer is past probe c - 1 and at
    // most probe c
    const int nhi = lo + c * step < hi ? lo + c * step : hi;
    lo = c ? lo + (c - 1) * step + 1 : lo;
    hi = c ? nhi : lo;
  }
  return lo;
}

}  // namespace
