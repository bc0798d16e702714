// Fills of the anti-diagonal affine-gap global DP: the direct fill as one
// warp per problem (narrow classes) and as one block of owned lanes per
// problem, and the streamed fill.
//
// Replaces, by entry point (TPU kernels in sedef_tpu/ops/wavefront.py):
//   sedef_fill_warp             wavefront_pallas_batch (body _dp_row), for
//                               classes of at most 128 lanes
//   sedef_fill_owned            the same, for classes of up to 4,096 lanes
//                               (fill_owned.cuh); few problems of a wider
//                               class take sedef_fill_cluster of
//                               tile_fill_cluster.cu (fill_plan of
//                               sedef_tpu_torch/ops/wavefront.py chooses)
//   sedef_fill_streamed         wavefront_pipelined_batch (:679, body
//                               _pipe_dp_row :619), under stream_plan
// All fills compute the same bytes on every band lane of the same layout.
// The recurrence is the one in the docstring of
// sedef_tpu_torch/ops/wavefront.py (ksw2 extz2's difference encoding,
// rotated so that row r is anti-diagonal r and lane t is target index t);
// the cell is dp_cell of dp_cell.cuh.
//
// Streams.  A stream is K problems of one (S_q, S_t) class laid back to
// back in the same lanes and staggered by S_q rows (K = 1 is the direct
// fill): stream row r, lane t belongs to problem k = m / S_q at query index
// j = m % S_q, m = r - t, for 0 <= m < K * S_q.  Lane t hands over from
// problem k to k + 1 exactly when k's band leaves it, so the triangles tile
// the rotated plane.  Problem k's direction rows are stream rows [k * S_q,
// k * S_q + S_q + S_t - 1) in the direct layout.  A cell reads only cells
// of its own problem or a boundary injection, which is a function of j
// alone: the top row (j == 0) sees (u, y) = (t ? q : 0, 0), lane -1 sees
// (x, v) = (0, j ? q : 0).
//
// Layout: p is (n_streams, n_rows, S_t) uint8, n_rows = K * S_q + S_t - 1
// (wavefront_np's layout for K = 1, no sublane/lane packing).  Only lanes of
// a row's band are defined; the traceback never reads others.
//
// What bounds it on the H100: 29 integer operations per band cell (6 for
// the score, 17 for the recurrence, 6 for the direction flags) and one byte
// stored, one dependency step per anti-diagonal.  At every batch size the
// integer instruction rate, not the byte stream, is the bound; at small
// batch the chain of rows is what is felt.
//
// The warp fill (classes of at most 128 lanes: 95% of stage 2b's gap DPs).
// With one block per problem, state in shared memory and a block barrier
// per row, a 128-lane row costs what a 1,024-lane row costs: the
// shared-memory round trip and the barrier, not instructions.  Here a warp
// owns a problem and a thread four neighbouring lanes: u, y, x, v and the
// travelling query codes of its lanes stay in registers, lane t - 1's x and
// v come from the thread's own registers or from the warp neighbour by
// __shfl_up_sync, and there is no barrier and no shared-memory state at
// all.  The query code travels with its diagonal (a thread shifts its codes
// by one lane per row and takes one new code, loaded a row ahead from the
// problem's codes in shared memory).  Several problems share a block, so a
// batch of thousands is a few hundred blocks.  Lanes outside a row's band
// compute values no band cell ever reads, and a thread stores its four
// bytes as one word in the rows in which its group meets the band.
//
// The owned-lane fill (fill_owned.cuh; classes of 129 to 4,096 lanes).  With
// threads striding over a row's band every cell costs four shared loads,
// two code loads, four shared stores and a one-byte global store.  Here a
// thread owns four neighbouring lanes for the whole problem: their target
// codes sit in registers, the state moves as one 16-byte shared word a
// plane, the four direction bytes leave as one 32-bit store, the query
// code travels with its diagonal in a register (one shared byte a row, not
// one a cell), and the row loop is unrolled by four so the parity planes
// are fixed at compile time: ~25 instructions a cell, and a 1,024-lane row
// at the instruction rate of its SM.  Still one barrier per row: lane t
// needs lane t - 1 of the row before.
//
// The streamed fill.  On the TPU a stream exists because the VPU computes
// all 128 lanes of a row, in band or not: chaining K problems in the same
// lanes fills the ramp rows of one with the band of the next (~2x less
// fill there).  On the H100 a warp whose lanes are all out of band issues
// nothing and other blocks take its issue slots, so a chain mostly makes
// the chain of dependent rows K times longer (the port's first streamed
// fill, one block per stream, K * S_q + S_t - 1 rows on one SM, ran at 7%
// of its bound).  The problems of a stream never read each other, so here
// they are filled side by side ("parallel"): each problem under the kernel
// fill_plan gives a direct fill of n_streams * K problems (a block of
// owned lanes, or a thread-block cluster, tile_fill_cluster.cu's
// MODE_PAR), written straight into the stream layout at stream row k *
// S_q, storing only its own band bytes (the rows are shared with the
// neighbouring problems; fill_owned.cuh says how).  That has the direct
// fill's cost and needs no global state slab at any class.  "chain" keeps
// a stream's K problems one after the other on one cluster
// (tile_fill_cluster.cu's MODE_FULL with K > 1), and only when forced:
// it loses to "parallel" at every square class, and where it beats it
// (narrow queries in long streams) the direct fill beats both.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_cell.cuh"
#include "fill_owned.cuh"

namespace {

using sedef::Score;
using sedef::WILD;
using sedef::dp_cell;

constexpr int WARP_LPT = 4;                  // lanes a thread owns
constexpr int WARP_LANES = 32 * WARP_LPT;    // the widest class of a warp
constexpr unsigned FULL = 0xffffffffu;

// VEC: S_t is a multiple of 4, so a thread's four bytes are one aligned word.
template <bool VEC>
__global__ void fill_warp_kernel(const int8_t* __restrict__ qseq,
                                 const int8_t* __restrict__ tgt,
                                 uint8_t* __restrict__ p, int B, int S_q,
                                 int S_t, Score s) {
  extern __shared__ int4 smem4[];
  const int ln = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp; the kernel has no block barrier
  int8_t* qs = reinterpret_cast<int8_t*>(smem4) + (size_t)warp * S_q;
  for (int k = ln; k < S_q; k += 32) qs[k] = qseq[(size_t)b * S_q + k];
  __syncwarp();
  const int t0 = ln * WARP_LPT;
  int tc[WARP_LPT];
  bool tw[WARP_LPT];
  int u[WARP_LPT], y[WARP_LPT], x[WARP_LPT], v[WARP_LPT], qc[WARP_LPT];
#pragma unroll
  for (int k = 0; k < WARP_LPT; ++k) {
    tc[k] = t0 + k < S_t ? tgt[(size_t)b * S_t + t0 + k] : WILD;
    tw[k] = tc[k] >= WILD;
    u[k] = y[k] = x[k] = v[k] = 0;
    qc[k] = WILD;
  }
  // the code that enters lane t0 in row r is q[r - t0]
  int qnext = t0 == 0 ? qs[0] : WILD;
  const int n_rows = S_q + S_t - 1;
  uint8_t* prow = p + (size_t)b * n_rows * S_t;
  for (int r = 0; r < n_rows; ++r, prow += S_t) {
    // lane t0 - 1 of the row before; lane -1 is (x, v) = (0, j ? q : 0)
    int xl = __shfl_up_sync(FULL, x[WARP_LPT - 1], 1);
    int vl = __shfl_up_sync(FULL, v[WARP_LPT - 1], 1);
    if (ln == 0) {
      xl = 0;
      vl = r > 0 ? s.gapo : 0;
    }
#pragma unroll
    for (int k = WARP_LPT - 1; k > 0; --k) qc[k] = qc[k - 1];
    qc[0] = qnext;
    const int jn = r + 1 - t0;
    qnext = (unsigned)jn < (unsigned)S_q ? qs[jn] : WILD;
    uint32_t word = 0;
    // descending, so lane k - 1's registers still hold the row before
#pragma unroll
    for (int k = WARP_LPT - 1; k >= 0; --k) {
      const int xs = k > 0 ? x[k > 0 ? k - 1 : 0] : xl;
      const int vs = k > 0 ? v[k > 0 ? k - 1 : 0] : vl;
      int ub = u[k], yb = y[k];
      if (t0 + k == r) {  // top row: (u, y) = (t ? q : 0, 0)
        ub = t0 + k > 0 ? s.gapo : 0;
        yb = 0;
      }
      const int nw = !(tw[k] || (unsigned)qc[k] >= (unsigned)WILD);
      const int eq = qc[k] == tc[k];
      const int sc = nw * (s.mis + eq * (s.match - s.mis));
      const int d = dp_cell(sc, xs, vs, ub, yb, s, u[k], v[k], x[k], y[k]);
      word |= (uint32_t)d << (8 * k);
    }
    // the rows in which the thread's group meets the band
    if (t0 <= r && t0 + WARP_LPT - 1 >= r - S_q + 1 && t0 < S_t) {
      if (VEC) {
        *reinterpret_cast<uint32_t*>(prow + t0) = word;
      } else {
#pragma unroll
        for (int k = 0; k < WARP_LPT; ++k)
          if (t0 + k < S_t) prow[t0 + k] = (uint8_t)(word >> (8 * k));
      }
    }
  }
}

constexpr long long SMEM_MAX = 227LL * 1024;

// The owned-lane fill of B problems: the direct layout, or (STREAM) streams
// of K problems.
template <bool STREAM>
int launch_owned(const void* qseq, const void* tgt, void* p, int B, int K,
                 int S_q, int S_t, int match, int mis, int gapo, int gape,
                 int unroll, void* stream) {
  const long long smem = 24LL * S_t + S_q;  // six int32 planes and the query
  if (S_q < 1 || S_t < 1 || S_t % sedef::LPT || S_t > 1024 * sedef::LPT ||
      smem > SMEM_MAX || (unroll != 2 && unroll != 4))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const int qe2 = 2 * (gapo + gape);
  const Score s = {match, mis, gapo, qe2, match + qe2};
  const int threads = (S_t / sedef::LPT + 31) / 32 * 32;
  const int8_t* q = static_cast<const int8_t*>(qseq);
  const int8_t* t = static_cast<const int8_t*>(tgt);
  uint8_t* pp = static_cast<uint8_t*>(p);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if constexpr (STREAM) {
    auto kernel = unroll == 2 ? sedef::fill_owned_streamed<2>
                              : sedef::fill_owned_streamed<4>;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      kernel<<<B, threads, (size_t)smem, cs>>>(q, t, pp, S_q, S_t, s, K);
  } else {
    auto kernel = unroll == 2 ? sedef::fill_owned<false, 2>
                              : sedef::fill_owned<false, 4>;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      kernel<<<B, threads, (size_t)smem, cs>>>(q, t, pp, S_q, S_t, s);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tile_fill_cluster.cu
int sedef_fill_cluster(const void* qseq, const void* tgt, void* p,
                       int n_streams, int K, int S_q, int S_t, int match,
                       int mis, int gapo, int gape, int parallel, int C,
                       int W, int LPT, int N, int ring, void* stream);

// Direct fill of a class of at most 128 lanes, one warp per problem and
// ``per_block`` problems a block.  qseq (B, S_q) int8, tgt (B, S_t) int8
// (wildcard 4 padded), p (B, S_q + S_t - 1, S_t) uint8.  Launches on
// ``stream`` without synchronising; returns a CUDA error code
// (cudaErrorInvalidValue for a class or a block it does not take).
int sedef_fill_warp(const void* qseq, const void* tgt, void* p, int B,
                    int S_q, int S_t, int match, int mis, int gapo, int gape,
                    int per_block, void* stream) {
  if (S_q < 1 || S_t < 1 || S_t > WARP_LANES || per_block < 1 ||
      per_block > 32 || (long long)per_block * S_q > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const int qe2 = 2 * (gapo + gape);
  const Score s = {match, mis, gapo, qe2, match + qe2};
  const int smem = per_block * S_q;
  const bool vec = S_t % WARP_LPT == 0;
  auto kernel = vec ? fill_warp_kernel<true> : fill_warp_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  kernel<<<(B + per_block - 1) / per_block, per_block * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qseq), static_cast<const int8_t*>(tgt),
      static_cast<uint8_t*>(p), B, S_q, S_t, s);
  return (int)cudaGetLastError();
}

// Direct fill of a class of up to 4,096 lanes, S_t a multiple of 4: one
// block per problem, four owned lanes a thread, ``unroll`` (2 or 4) rows an
// unrolled step.  Other arguments as sedef_fill_warp's.
int sedef_fill_owned(const void* qseq, const void* tgt, void* p, int B,
                     int S_q, int S_t, int match, int mis, int gapo, int gape,
                     int unroll, void* stream) {
  return launch_owned<false>(qseq, tgt, p, B, 1, S_q, S_t, match, mis, gapo,
                             gape, unroll, stream);
}

// Streamed fill of n_streams streams of K problems: qseq (n_streams * K,
// S_q), tgt (n_streams * K, S_t) int8, problem k of stream s at row s * K +
// k; p (n_streams, K * S_q + S_t - 1, S_t) uint8.  Under the plan of
// stream_plan (sedef_tpu_torch/ops/wavefront.py): ``org`` 0, "parallel" over
// owned lanes (one block a problem, ``N`` = 2 or 4 rows an unrolled step);
// 1, "parallel" over a cluster of C blocks of W lanes a problem (LPT lanes
// a thread, a cluster barrier every N rows, seam rings of ``ring`` slots);
// 2, "chain": the same cluster fill, one stream of K problems a cluster.
// Launches on ``stream`` without synchronising; returns a CUDA error code
// (cudaErrorInvalidValue for a plan or a class the kernel does not take).
int sedef_fill_streamed(const void* qseq, const void* tgt, void* p,
                        int n_streams, int K, int S_q, int S_t, int match,
                        int mis, int gapo, int gape, int org, int C, int W,
                        int LPT, int N, int ring, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  switch (org) {
    case 0:
      return launch_owned<true>(qseq, tgt, p, n_streams * K, K, S_q, S_t,
                                match, mis, gapo, gape, N, stream);
    case 1:
    case 2:
      return sedef_fill_cluster(qseq, tgt, p, n_streams, K, S_q, S_t, match,
                                mis, gapo, gape, org == 1, C, W, LPT, N,
                                ring, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
