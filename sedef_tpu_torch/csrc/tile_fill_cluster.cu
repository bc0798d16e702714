// The tiled route's two fills, plain and streamed, and the direct fill of
// few problems of a wide class: one stream's lanes split over the blocks of
// a thread-block cluster.
//
// Replaces _ckpt_pass and _refill_tile of sedef_tpu/ops/wavefront.py (the
// TPU kernels behind tile_checkpoint and tile_refill), with K > 1
// problems per stream _ckpt_pass_pipe and _refill_tile_pipe
// (tile_checkpoint_streamed, tile_refill_streamed), and, run from the zero
// state over all S_q + S_t - 1 rows straight into the direction matrix,
// wavefront_pallas_batch (wavefront_fill; sedef_fill_cluster below: no
// checkpoint is read or written, and the row count need not be even), and
// with K > 1 problems a stream, or each of a stream's problems in a cluster
// of its own written into the stream layout (MODE_PAR),
// wavefront_pipelined_batch (wavefront_fill_streamed, under the plan
// stream_plan calls "chain" or "parallel" over clusters).  The
// recurrence is the
// one in the docstring of sedef_tpu_torch/ops/wavefront.py; the stream
// layout is wavefront_fill.cu's: stream row r, lane t belongs to problem
// k = m / S_q at query index j = m % S_q, m = r - t, for 0 <= m < Q =
// K * S_q (the band).  A tile is (n_streams, tile, S_t) uint8 direction
// rows, a checkpoint the state entering a tile, (n_streams, n_tiles, 4,
// S_t) int32 planes u, y, x, v.  Lanes outside the band hold values no band
// cell ever reads (a band cell reads the band cell of the same query index
// one lane to the left, the band cell of the same lane one query index up,
// or a boundary injection), so they are computed in whole groups of a
// thread's lanes, or not at all, and their bytes and checkpoint words are
// undefined.
//
// What bounds it on the H100.  29 integer operations per band cell (23 in
// the checkpoint pass, which keeps no direction flags) and a chain of
// Q + S_t - 1 dependent rows.  The tiled route has at most eight streams
// per launch, so with one block per stream a 10 Kbp class runs on 4 to 8 of
// the card's SMs and a 60 Kbp chunk on one, and from S_t = 10,240 on the
// state no longer fits one block's shared memory.  A row's instructions
// on one SM, not the barrier after it, set the time.  The direct fill's
// launch groups are small too, so from 2,048 lanes on fill_plan gives each
// of a few problems as many blocks as the card has SMs free (narrower
// classes are faster in one block of owned lanes, fill_owned.cuh: a block's
// row costs 0.35-0.48 us here at any width).
//
// What the design does about it.
//  * Lanes over a cluster.  Block c of a cluster of C owns the contiguous
//    lanes [c * W, (c + 1) * W) of one stream; the grid is n_streams * C
//    blocks.  A row's cells are spread over C SMs, and a block's state (u, y
//    in place; x, v in two row-parity planes: 24 * W bytes) fits shared
//    memory at every size, so there is no global scratch slab.
//  * The seam.  A cell needs x and v of lane t - 1 from the row before.
//    Across a block boundary that is two int32 per row, which block c - 1's
//    last thread writes through distributed shared memory into a ring in
//    block c's shared memory, slot r & (ring - 1) for row r.
//  * The skewed schedule.  In step st block c fills rows (st - c) * N ..
//    + N - 1 (from r_begin), N rows behind block c - 1, so the seam values
//    of the row before were written at least one step earlier, and the
//    cluster barrier (~0.6 us on 16 SMs) comes once per N rows; inside a
//    block one __syncthreads() per row remains.  A launch takes
//    ceil(rows / N) + C - 1 steps.  During a step a receiver reads the seam
//    of rows R0 - 1 .. R0 + N - 2 while its sender writes rows R0 + N ..
//    R0 + 2 N - 1: 2 N + 1 rows are live, so the ring has the next power of
//    two of slots (4 N); 2 N is one too few
//    (tests/test_torch_tile_cluster.py runs the schedule on the CPU with
//    poisoned slots).
//  * The owned-lane cell of the variant harness (hoist / unroll2 of
//    wavefront_fill_variants.cu): LPT consecutive lanes per thread, target
//    codes in registers (reloaded when a lane passes to the stream's next
//    problem), one access per state plane (16 bytes at LPT = 4), one store
//    for a thread's direction bytes, for even N the parity planes fixed at
//    compile time, and no boundary selects in the rows in which no lane of
//    the warp is on its top row.  The query code travels with its diagonal:
//    a thread shifts its codes by one lane per row and loads one new code,
//    a row ahead.  A counter (the query index of the thread's first lane)
//    replaces the per-cell division of the streamed template.
//  * Lanes per thread follow the block's width (LPT = 1, 2 or 4: the fewest
//    that 1024 threads cover W with, and two from 512 lanes on; tile_plan
//    chooses).  A row of a few hundred lanes is bound by one warp's chain
//    of dependent instructions, not by the SM's instruction rate, so it is
//    faster as many warps of one lane a thread; a row of thousands of lanes
//    is throughput-bound and wants the fewest instructions per cell, four
//    lanes a thread.
//  * Rows outside a block's band cost nothing but the barrier: block c's
//    lanes meet the band only in rows [c * W, Q + last lane], a thread's
//    group only in rows [t0, Q + t0 + LPT - 1).
//  * Each block stores its own segment of a checkpoint when it reaches a
//    tile's first row, and a refill loads its segment (and, for c > 0, the
//    seam value of the row before from lane c * W - 1's planes).
// The max chains are plain integer max/min beside the strict '>' tests in
// order that decide the direction byte (Hopper's __vibmax_s32 returns the
// maximum and the predicate in one instruction: the variant harness times
// that form, wavefront_fill_variants.cu).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_cell.cuh"

namespace cg = cooperative_groups;

namespace {

using sedef::Score;
using sedef::WILD;
using sedef::dp_cell;

// MODE_FULL: a whole fill from the zero state into the direction matrix.
// MODE_PAR: the same, one problem a cluster (K = 1), problem b written at
// stream row (b % ks) * S_q of stream b / ks of a layout of streams of ks
// problems (wavefront_fill.cu); the stream's other problems share its rows,
// so a thread stores only its own band bytes (fill_owned.cuh's stream mode
// says how).
enum { MODE_CKPT = 1, MODE_REFILL = 2, MODE_FULL = 3, MODE_PAR = 4 };

constexpr int MAX_THREADS = 1024;
constexpr int MAX_LPT = 4;

// How one stream's lanes are laid over a cluster: C blocks of W lanes (W a
// multiple of 4, C * W >= S_t), LPT consecutive lanes a thread (1, 2 or 4),
// a cluster barrier every N rows, seam rings of ``ring`` slots (a power of
// two above 2 * N).  Derived by tile_plan of
// sedef_tpu_torch/ops/wavefront.py.
struct TilePlan {
  int C, W, LPT, N, ring;
};

// LPT consecutive int32 of a shared-memory plane, as one access.
template <int LPT>
__device__ __forceinline__ void load_lanes(const int32_t* p, int (&o)[LPT]) {
  if constexpr (LPT == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else if constexpr (LPT == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    o[0] = v.x, o[1] = v.y;
  } else {
    o[0] = *p;
  }
}

template <int LPT>
__device__ __forceinline__ void store_lanes(int32_t* p,
                                            const int (&v)[LPT]) {
  if constexpr (LPT == 4)
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  else if constexpr (LPT == 2)
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  else
    *p = v[0];
}

// What a thread needs for a row and does not change between rows.
struct Lanes {
  int32_t *U, *Y, *X, *V;    // the block's state, W lanes a plane
  const int32_t *RX, *RV;    // inbound seam ring (written by block c - 1)
  int32_t *SX, *SV;          // outbound seam ring, in block c + 1
  int W, mask;               // lanes per block; ring slots - 1
  int c, l0, t0;             // block rank; first owned lane: local, global
  bool sends;                // owns the block's last lane and c < C - 1
  bool vec;                  // S_t % LPT == 0: one store for a row's bytes
};

// What travels with a thread from row to row: the query codes of its
// lanes, the code that enters at lane t0 next, the query index j0 and the
// problem kk0 of lane t0 (lane t0 + k is at j0 - k, or still in problem
// kk0 - 1 when that is negative), and the target codes (tw: wildcard) of
// the problems its lanes are in.
template <int LPT>
struct Travel {
  int qc[LPT], qnext, j0, kk0;
  int tc[LPT];
  bool tw[LPT];
};

template <int LPT>
__device__ __forceinline__ void load_target(Travel<LPT>& T, int k,
                                            const int8_t* __restrict__ ts,
                                            int kk, int K, int t, int S_t) {
  T.tc[k] = kk < K && t < S_t ? ts[(size_t)kk * S_t + t] : WILD;
  T.tw[k] = T.tc[k] >= WILD;
}

// Row r of the thread that owns lanes [t0, t0 + LPT).  ``par`` = r & 1
// names the parity plane this row writes; it reads the other one.  On entry
// T.qc holds the codes of row r - 1, T.qnext the code entering at lane t0
// in row r, and T.j0, T.kk0 are row r's; on exit all are a row further.
// qs: the stream's Q query codes; ts: its K target strings.  TOP: one of
// the lanes may be on its top row (j0 < LPT); without it the row has no
// boundary selects and loads no target code.
template <int MODE, int LPT, bool TOP>
__device__ __forceinline__ void fill_row(int r, int par, const Lanes& L,
                                         const int8_t* __restrict__ qs,
                                         const int8_t* __restrict__ ts,
                                         int K, int S_q, int S_t,
                                         Travel<LPT>& T, const Score& s,
                                         uint8_t* prow) {
  int (&qc)[LPT] = T.qc;
#pragma unroll
  for (int k = LPT - 1; k > 0; --k) qc[k] = qc[k - 1];
  qc[0] = T.qnext;
  const int jn = r + 1 - L.t0;
  T.qnext = (unsigned)jn < (unsigned)(K * S_q) ? qs[jn] : WILD;
  // a lane on its top row (j == 0) enters problem kk0: its target code
  if (TOP) {
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if (T.j0 == k) load_target(T, k, ts, T.kk0, K, L.t0 + k, S_t);
  }
  const int32_t* Xp = L.X + (par ^ 1) * L.W;
  const int32_t* Vp = L.V + (par ^ 1) * L.W;
  int ub[LPT], yb[LPT], xp[LPT], vp[LPT];
  load_lanes<LPT>(L.U + L.l0, ub);
  load_lanes<LPT>(L.Y + L.l0, yb);
  if (LPT > 1) {
    load_lanes<LPT>(Xp + L.l0, xp);
    load_lanes<LPT>(Vp + L.l0, vp);
  }
  // lane t - 1 of the row before, for the thread's lanes
  int xl[LPT], vl[LPT];
#pragma unroll
  for (int k = 1; k < LPT; ++k) xl[k] = xp[k - 1], vl[k] = vp[k - 1];
  if (L.l0 > 0) {
    xl[0] = Xp[L.l0 - 1];
    vl[0] = Vp[L.l0 - 1];
  } else if (L.c > 0) {
    const int slot = (r - 1) & L.mask;
    xl[0] = L.RX[slot];
    vl[0] = L.RV[slot];
  } else {  // lane -1: (x, v) = (0, j ? q : 0)
    xl[0] = 0;
    vl[0] = T.j0 > 0 ? s.gapo : 0;
  }
  int un[LPT], yn[LPT], xn[LPT], vn[LPT];
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    // scalars, not writes into ub / yb: the compiler would index those by
    // j0 and move them to local memory
    int u_in = ub[k], y_in = yb[k];
    if (TOP && T.j0 == k) {  // top row: (u, y) = (t ? q : 0, 0)
      u_in = L.t0 + k > 0 ? s.gapo : 0;
      y_in = 0;
    }
    // the score as arithmetic: nested selects of match / mis tempt the
    // compiler into predicated constant loads on the row's critical path
    const int nw = !(T.tw[k] || (unsigned)qc[k] >= (unsigned)WILD);
    const int eq = qc[k] == T.tc[k];
    const int sc = nw * (s.mis + eq * (s.match - s.mis));
    const int d = dp_cell(sc, xl[k], vl[k], u_in, y_in, s, un[k], vn[k],
                          xn[k], yn[k]);
    word |= (uint32_t)d << (8 * k);
  }
  store_lanes<LPT>(L.U + L.l0, un);
  store_lanes<LPT>(L.Y + L.l0, yn);
  store_lanes<LPT>(L.X + par * L.W + L.l0, xn);
  store_lanes<LPT>(L.V + par * L.W + L.l0, vn);
  if (L.sends) {
    const int slot = r & L.mask;
    L.SX[slot] = xn[LPT - 1];
    L.SV[slot] = vn[LPT - 1];
  }
  if (MODE != MODE_CKPT) {
    // MODE_PAR: whole words only where all the thread's lanes are in band
    const int m0 = r - L.t0;
    const bool whole = MODE != MODE_PAR || (m0 >= LPT - 1 && m0 < K * S_q);
    if (LPT == 1) {  // a thread's rows are its lane's band rows
      prow[L.t0] = (uint8_t)word;
    } else if (L.vec && whole) {
      if (LPT == 4)
        *reinterpret_cast<uint32_t*>(prow + L.t0) = word;
      else
        *reinterpret_cast<uint16_t*>(prow + L.t0) = (uint16_t)word;
    } else {
#pragma unroll
      for (int k = 0; k < LPT; ++k)
        if (L.t0 + k < S_t &&
            (MODE != MODE_PAR || (unsigned)(m0 - k) < (unsigned)(K * S_q)))
          prow[L.t0 + k] = (uint8_t)(word >> (8 * k));
    }
  }
  if (++T.j0 == S_q) {
    T.j0 = 0;
    ++T.kk0;
  }
}

// The thread's lanes of the state entering row r, into the planes of tile
// r / tile.  A thread stores what it wrote itself, so no barrier.
template <int LPT>
__device__ __forceinline__ void store_ckpt(int r, const Lanes& L, int S_t,
                                           int32_t* __restrict__ ck) {
  const int pp = ((r & 1) ^ 1) * L.W;
  const int32_t* src[4] = {L.U, L.Y, L.X + pp, L.V + pp};
#pragma unroll
  for (int pl = 0; pl < 4; ++pl) {
    int32_t* dst = ck + (size_t)pl * S_t + L.t0;
    if (L.vec) {
      int v[LPT];
      load_lanes<LPT>(src[pl] + L.l0, v);
      store_lanes<LPT>(dst, v);
    } else {
#pragma unroll
      for (int k = 0; k < LPT; ++k)
        if (L.t0 + k < S_t) dst[k] = src[pl][L.l0 + k];
    }
  }
}

template <int MODE, int LPT>
__global__ void __launch_bounds__(MAX_THREADS)
    tile_fill_cluster(const int8_t* __restrict__ qseq,
                      const int8_t* __restrict__ tgt,
                      uint8_t* __restrict__ p_tile,
                      int32_t* __restrict__ ckpt, int K, int S_q, int S_t,
                      int r_begin, int r_end, int tile, int n_tiles, int C,
                      int W, int N, int ring, int ks, Score s) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int sidx = blockIdx.x / C;
  Lanes L;
  L.U = smem;
  L.Y = smem + W;
  L.X = smem + 2 * W;
  L.V = smem + 4 * W;
  int32_t* RX = smem + 6 * W;
  int32_t* RV = RX + ring;
  L.RX = RX;
  L.RV = RV;
  L.W = W;
  L.mask = ring - 1;
  L.c = c;
  L.l0 = threadIdx.x * LPT;
  L.t0 = c * W + L.l0;
  L.vec = S_t % LPT == 0;  // W, so every t0, is a multiple of 4
  L.sends = c < C - 1 && L.l0 == W - LPT;
  L.SX = L.SV = nullptr;
  if (c < C - 1) {
    L.SX = cluster.map_shared_rank(RX, c + 1);
    L.SV = cluster.map_shared_rank(RV, c + 1);
  }
  const bool mine = L.l0 < W && L.t0 < S_t;
  const int Q = K * S_q;  // the stream's query length
  const int8_t* qs = qseq + (size_t)sidx * Q;
  const int8_t* ts = tgt + (size_t)sidx * K * S_t;

  // the state entering row r_begin: zero, or the tile's checkpoint (r_begin
  // is even, so row r_begin - 1 left x and v in parity plane 1)
  if (mine) {
    const int32_t* ck =
        MODE == MODE_REFILL
            ? ckpt + ((size_t)sidx * n_tiles + r_begin / tile) * 4 * S_t
            : nullptr;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int t = L.t0 + k, l = L.l0 + k;
      const bool load = MODE == MODE_REFILL && t < S_t;
      L.U[l] = load ? ck[t] : 0;
      L.Y[l] = load ? ck[S_t + t] : 0;
      L.X[l] = L.V[l] = 0;
      L.X[W + l] = load ? ck[2 * S_t + t] : 0;
      L.V[W + l] = load ? ck[3 * S_t + t] : 0;
    }
    if (MODE == MODE_REFILL && L.l0 == 0 && c > 0) {
      const int slot = (r_begin - 1) & L.mask;
      RX[slot] = ck[2 * S_t + L.t0 - 1];
      RV[slot] = ck[3 * S_t + L.t0 - 1];
    }
  }
  // every block of the cluster runs before any writes into a neighbour
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();

  // rows in which the block's lanes, and the thread's group, meet the band
  // (one more for the block: the checkpoint of the row after a lane's last)
  const int lane_hi = min(c * W + W, S_t) - 1;
  const int blk_r0 = max(r_begin, c * W);
  const int blk_r1 = lane_hi < c * W ? blk_r0 : min(r_end, Q + lane_hi + 1);
  const int th_r0 = max(r_begin, L.t0);
  const int th_r1 = mine ? min(r_end, Q + L.t0 + LPT - 1) : th_r0;
  // the travelling state as the thread's first row, th_r0, finds it
  Travel<LPT> T;
  const int m0 = th_r0 - L.t0;
  T.kk0 = m0 / S_q;
  T.j0 = m0 - T.kk0 * S_q;
  T.qnext = m0 < Q ? qs[m0] : WILD;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int m = m0 - 1 - k;
    T.qc[k] = (unsigned)m < (unsigned)Q ? qs[m] : WILD;
    load_target(T, k, ts, T.j0 >= k ? T.kk0 : max(T.kk0 - 1, 0), K,
                L.t0 + k, S_t);
  }
  // the first row of a tile at or after the block's first row
  int next_ck = (blk_r0 + tile - 1) / tile * tile;
  // the stream's rows, row 0 = r_begin: a tile's, or (MODE_FULL, where
  // ``tile`` is the whole row count) the stream's direction matrix, or
  // (MODE_PAR) the problem's rows inside its stream
  uint8_t* pb = p_tile;
  if (MODE == MODE_PAR)
    pb += ((size_t)(sidx / ks) * (ks * S_q + S_t - 1) +
           (size_t)(sidx % ks) * S_q) * S_t;
  else if (MODE != MODE_CKPT)
    pb += (size_t)sidx * tile * S_t;

  auto do_row = [&](int r, int par, int lo, int hi) {
    if (r < lo || r >= hi) return;  // block-uniform
    if (MODE == MODE_CKPT && r == next_ck) {
      if (mine)
        store_ckpt<LPT>(r, L, S_t,
                   ckpt + ((size_t)sidx * n_tiles + r / tile) * 4 * S_t);
      next_ck += tile;
    }
    if (r >= th_r0 && r < th_r1) {
      // the whole warp takes the row with boundary selects when any of its
      // threads has a lane on its top row, so the two never diverge
      uint8_t* prow = pb + (size_t)(r - r_begin) * S_t;
      if (__any_sync(__activemask(), T.j0 < LPT))
        fill_row<MODE, LPT, true>(r, par, L, qs, ts, K, S_q, S_t, T, s,
                                  prow);
      else
        fill_row<MODE, LPT, false>(r, par, L, qs, ts, K, S_q, S_t, T, s,
                                   prow);
    }
    __syncthreads();
  };

  const int n_steps = (r_end - r_begin + N - 1) / N + C - 1;
  for (int st = 0; st < n_steps; ++st) {
    const int R0 = r_begin + (st - c) * N;
    const int lo = max(R0, blk_r0);
    const int hi = min(R0 + N, blk_r1);
    if (lo < hi) {
      if (N & 1) {
        for (int r = lo; r < hi; ++r) do_row(r, r & 1, lo, hi);
      } else {  // R0 is even: the parity planes are fixed at compile time
        for (int r = R0; r < R0 + N; r += 2) {
          do_row(r, 0, lo, hi);
          do_row(r + 1, 1, lo, hi);
        }
      }
    }
    if (C > 1) cluster.sync();
  }
}

// The launch configuration of ``kernel`` under the plan; 0 or a CUDA error.
template <typename Kernel>
int config(Kernel kernel, const TilePlan& pl, int n_streams,
           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
           cudaStream_t cs) {
  const size_t smem = (size_t)(6 * pl.W + 2 * pl.ring) * sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // clusters of more than 8 blocks are a non-portable size
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             pl.C > 8 ? 1 : 0);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused shape must not fail the next launch
    return (int)e;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(n_streams * pl.C));
  cfg->blockDim = dim3((unsigned)((pl.W / pl.LPT + 31) / 32 * 32));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = cs;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)pl.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

bool valid(const TilePlan& pl) {
  return pl.C >= 1 && pl.N >= 1 && (pl.N == 1 || pl.N % 2 == 0) &&
         (pl.LPT == 1 || pl.LPT == 2 || pl.LPT == 4) && pl.W >= MAX_LPT &&
         pl.W % MAX_LPT == 0 && pl.W <= MAX_THREADS * pl.LPT &&
         pl.ring > 2 * pl.N && (pl.ring & (pl.ring - 1)) == 0;
}

struct Args {
  const int8_t *qseq, *tgt;
  uint8_t* p_tile;
  int32_t* ckpt;
  int n_streams, K, S_q, S_t, tile, ti, ks;
  Score s;
  cudaStream_t cs;
};

// Launch (``out`` null) or, with ``out``, only ask how many clusters of the
// plan's shape the card holds at once.
template <int MODE, int LPT>
int launch_as(const TilePlan& pl, const Args& a, int* out) {
  auto kernel = tile_fill_cluster<MODE, LPT>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc = config(kernel, pl, a.n_streams, &cfg, &attr, a.cs);
  if (rc) return rc;
  cudaError_t e;
  if (out != nullptr) {
    e = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  } else {
    const int n_rows = a.K * a.S_q + a.S_t - 1;
    const int n_tiles = (n_rows + a.tile - 1) / a.tile;
    // the checkpoint pass and the whole fill run every row, a refill those
    // of tile ``ti``
    const int r0 = MODE == MODE_REFILL ? a.ti * a.tile : 0;
    const int r1 = MODE == MODE_REFILL && r0 + a.tile < n_rows ? r0 + a.tile
                                                               : n_rows;
    e = cudaLaunchKernelEx(&cfg, kernel, a.qseq, a.tgt, a.p_tile, a.ckpt,
                           a.K, a.S_q, a.S_t, r0, r1, a.tile, n_tiles, pl.C,
                           pl.W, pl.N, pl.ring, a.ks, a.s);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch must not fail the next one
    return (int)e;
  }
  return (int)cudaGetLastError();
}

template <int MODE>
int launch(const TilePlan& pl, const Args& a, int* out) {
  if (!valid(pl)) return (int)cudaErrorInvalidValue;
  switch (pl.LPT) {
    case 1: return launch_as<MODE, 1>(pl, a, out);
    case 2: return launch_as<MODE, 2>(pl, a, out);
    default: return launch_as<MODE, 4>(pl, a, out);
  }
}

// ``ks``: problems a stream of MODE_PAR's output layout (1 otherwise).
template <int MODE>
int run(const TilePlan& pl, const void* qseq, const void* tgt, void* p_tile,
        void* ckpt, int n_streams, int K, int S_q, int S_t, int tile, int ti,
        int match, int mis, int gapo, int gape, void* stream, int ks = 1) {
  if (n_streams <= 0) return (int)cudaGetLastError();
  // a thread's lanes reach their top rows one after the other (fill_row's
  // j0 == k), so a problem is at least as long as a thread's group is wide
  if (K < 1 || ks < 1 || (MODE == MODE_PAR && K != 1) || S_q < pl.LPT ||
      S_t < 1 || (long long)pl.C * pl.W < S_t)
    return (int)cudaErrorInvalidValue;
  if (MODE == MODE_FULL || MODE == MODE_PAR)
    tile = K * S_q + S_t - 1;  // one "tile": the direction matrix's rows
  else if (tile < 2 || tile % 2)
    return (int)cudaErrorInvalidValue;
  const int qe2 = 2 * (gapo + gape);
  const Args a = {static_cast<const int8_t*>(qseq),
                  static_cast<const int8_t*>(tgt),
                  static_cast<uint8_t*>(p_tile),
                  static_cast<int32_t*>(ckpt),
                  n_streams, K, S_q, S_t, tile, ti, ks,
                  {match, mis, gapo, qe2, match + qe2},
                  static_cast<cudaStream_t>(stream)};
  return launch<MODE>(pl, a, nullptr);
}

}  // namespace

extern "C" {

// Checkpoint pass of the tiled route: the whole fill of n_streams streams of
// K problems (qseq (n_streams * K, S_q), tgt (n_streams * K, S_t) int8,
// problem k of stream s at row s * K + k), storing only the state entering
// each tile, ckpt (n_streams, n_tiles, 4, S_t) int32, under the plan (C, W,
// LPT, N, ring).  Launches on ``stream`` without synchronising; returns a
// CUDA error code, the launch's own when the card refuses the cluster.
int sedef_tile_ckpt(const void* qseq, const void* tgt, void* ckpt,
                    int n_streams, int K, int S_q, int S_t, int tile,
                    int match, int mis, int gapo, int gape, int C, int W,
                    int LPT, int N, int ring, void* stream) {
  return run<MODE_CKPT>({C, W, LPT, N, ring}, qseq, tgt, nullptr, ckpt,
                        n_streams, K, S_q, S_t, tile, 0, match, mis, gapo,
                        gape, stream);
}

// Refill of tile ``ti``: rows [ti * tile, min((ti + 1) * tile, n_rows))
// from its checkpoint into p_tile (n_streams, tile, S_t) uint8.
int sedef_tile_refill(const void* qseq, const void* tgt, const void* ckpt,
                      void* p_tile, int n_streams, int K, int S_q, int S_t,
                      int tile, int ti, int match, int mis, int gapo,
                      int gape, int C, int W, int LPT, int N, int ring,
                      void* stream) {
  return run<MODE_REFILL>({C, W, LPT, N, ring}, qseq, tgt, p_tile,
                          const_cast<void*>(ckpt), n_streams, K, S_q, S_t,
                          tile, ti, match, mis, gapo, gape, stream);
}

// The whole fill under the same plan, from the zero state into the
// direction rows of n_streams streams of K problems (qseq (n_streams * K,
// S_q), tgt (n_streams * K, S_t) int8, problem k of stream s at row s * K +
// k; p (n_streams, K * S_q + S_t - 1, S_t) uint8; K = 1 is the direct
// fill).  ``parallel`` 0: a cluster a stream, its K problems one after the
// other in the cluster's lanes; 1: a cluster a problem, all at once, each
// written into its stream's rows (MODE_PAR).  C = 1 is one block per
// cluster with owned lanes.
int sedef_fill_cluster(const void* qseq, const void* tgt, void* p,
                       int n_streams, int K, int S_q, int S_t, int match,
                       int mis, int gapo, int gape, int parallel, int C,
                       int W, int LPT, int N, int ring, void* stream) {
  const TilePlan pl = {C, W, LPT, N, ring};
  if (parallel)
    return run<MODE_PAR>(pl, qseq, tgt, p, nullptr, n_streams * K, 1, S_q,
                         S_t, 0, 0, match, mis, gapo, gape, stream, K);
  return run<MODE_FULL>(pl, qseq, tgt, p, nullptr, n_streams, K, S_q, S_t,
                        0, 0, match, mis, gapo, gape, stream);
}

// Clusters of the plan's shape that the card can hold at once
// (cudaOccupancyMaxActiveClusters), into *out; 0 means a launch would be
// refused.  ``mode`` picks the kernel: 0 the checkpoint pass, 1 the
// refill, 2 the whole fill, 3 the whole fill of one of a stream's problems
// (MODE_PAR).  Returns a CUDA error code.
int sedef_tile_cluster_occupancy(int mode, int n_streams, int C, int W,
                                 int LPT, int N, int ring, int* out) {
  const TilePlan pl = {C, W, LPT, N, ring};
  Args a = {};
  a.n_streams = n_streams;
  switch (mode) {
    case 0: return launch<MODE_CKPT>(pl, a, out);
    case 1: return launch<MODE_REFILL>(pl, a, out);
    case 2: return launch<MODE_FULL>(pl, a, out);
    default: return launch<MODE_PAR>(pl, a, out);
  }
}

}  // extern "C"
