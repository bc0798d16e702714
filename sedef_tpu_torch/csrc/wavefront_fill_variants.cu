// The direct fill of the anti-diagonal affine-gap DP under a family of
// implementations of the same recurrence: the variant harness.
//
// Replaces make_kernel / run of tools/kbench.py:25 (the TPU experiment
// kernel: base, hoist, unroll*, pack*, reg*, preg*, bspec*).  Every variant
// computes what the direct fill (wavefront_fill) computes, p (B, S_q + S_t -
// 1, S_t) uint8 with row r = anti-diagonal r and lane t = target index t,
// and must give the same bytes on every lane of a row's band (0 <= r - t <
// S_q); the recurrence is the one in the docstring of
// sedef_tpu_torch/ops/wavefront.py.  The variants are the card's forms of
// the TPU harness's ideas, not its blocks: there are no sublane groups, no
// 128-lane padding and no chunk grid here.
//
// Three organisations, one block per problem in each:
//
//   base     the port's first direct fill (and still the streamed fill's
//            organisation, wavefront_fill.cu): state (u, y in place; x, v
//            in two row-parity planes) and both code strings in shared
//            memory, threads striding over a row's band, one byte stored
//            per cell, one __syncthreads() per row.  The yardstick.
//   hoist    (fill_owned.cuh, which the direct fill launches too) each
//            thread owns four neighbouring lanes for the whole
//            problem: their target codes and wildcard flags sit in
//            registers, the state is read and written as one 16-byte
//            shared-memory word per plane, and the four direction bytes
//            leave as one 32-bit store.  unroll2 / unroll4 unroll the row
//            loop (the parity planes become compile-time), still one
//            barrier per row: lane t needs lane t - 1 of the row before.
//            vibmax is unroll2 with the cell's two max-and-test steps as
//            one instruction each: Hopper's __vibmax_s32 returns max(a, b)
//            and the predicate a >= b, and the strict test "a > z" that
//            decides a direction bit is the complement of the predicate of
//            max(z, a).  (__vimax3 and the other DPX maxima report no
//            predicate and cannot decide the byte.)
//   reg      u, y, x, v and the travelling query code of the four owned
//            lanes live in registers; lane t - 1's x, v and code come from
//            the thread's own registers, from the warp neighbour by
//            __shfl_up_sync, and only at a warp seam (every 128 lanes)
//            through a small ring in shared memory.  The query code
//            travels with its diagonal (lane t of row r takes lane t - 1's
//            code of row r - 1), so no code is loaded per cell.  Warp w
//            runs w * N rows behind warp w - 1, so the seam values it needs
//            were written a step earlier and a block barrier is due only
//            every N rows (reg = 1, reg2, reg4); a block of one warp
//            (S_t <= 128) needs none for its data.
//
//   pack*    (hoist organisation) and preg* (reg organisation) keep x, v +
//            128 and the query code in one 32-bit word, bits 0-7, 8-15 and
//            16-19 (the TPU harness's layout), so lane t - 1's state is one
//            shared word or one shuffle instead of three.  Eight bits are
//            enough in the band: there z >= a and z >= b before the clamp,
//            so u = z - vs >= xs >= 0 and v = z - ub >= yb >= 0, both at
//            most max_sc = match + 2 * (gapo + gape), and x, y lie in
//            [0, gapo]; the wrapper refuses scores with max_sc > 127.
//   bspec*   (reg organisation) rows r >= max(S_q, S_t) take a row body
//            with no boundary selects: lane 0 has left the band and no
//            lane is on the top row any more.
//
// Lanes outside a row's band compute values no band cell ever reads (a
// band cell reads the band cell of the same query index one lane to the
// left, the band cell of the same lane one query index up, or a boundary
// injection), so the owned-lane variants compute whole 4-lane groups and
// store whole words; the bytes they leave outside the band are undefined,
// as they are unwritten in base.  Threads (hoist) or warps (reg) whose
// lanes are all outside the band skip the row.
//
// What bounds it on the H100: 29 integer operations per band cell (6 for
// the score, 17 for the recurrence, 6 for the direction flags) and one
// byte stored; at a card-filling batch the integer instruction rate, at a
// small batch the chain of rows (one barrier, or one shuffle, per
// anti-diagonal).  Measured (PERF.md): the word cell cuts a row body from
// 174 to 118 instructions and the full card's time by ~30%; a problem
// alone takes 0.15-0.28 us a row in every organisation even at one warp's
// width, over one SM or a cluster, so at a small batch the latency of a
// row's dependent chain, not its instruction count or its SMs, sets it.
// The owned-lane variants take both on: four cells per thread between
// synchronisations, a quarter of the store instructions, and in reg no
// shared-memory traffic for the state at all.  The strict '>' tests in
// order and then the clamp decide the direction byte in every variant.
//
// The owned-lane variants take S_t a multiple of 4 up to 4096 (1024
// threads of 4 lanes); all variants keep their state in shared memory or
// registers, so a class must fit 227 KB.
//
// The redesign for the H100 (dp_cell2.cuh and the two organisations at the
// end of the dispatch table).  The records name two limits of the rows
// above: a row is bound by the integer instructions of one SM (~25 a cell
// in the owned-lane row, one lane per 32-bit instruction, though every
// in-band value fits 16 bits), and one block a problem leaves SMs idle
// whenever a launch holds fewer problems than the card has SMs (the main
// path's wide classes come 1-5 problems a launch).
//
//   dpx2*    the two-lanes-a-word cell (dp_cell2.cuh): lanes 2j and 2j + 1
//            in the int16 halves of one word for every plane, each step one
//            Hopper instruction on both halves (VIADD.16x2, the DPX maxima
//            VIMNMX.S16x2 with predicates, VIADDMNMX.S16x2.RELU), lane t - 1
//            by one byte_perm.  dpx2 / dpx2u4: the owned-lane organisation
//            (hoist's, two / four rows an unrolled step, the state as words
//            in shared memory: 12 bytes a lane instead of 24); dpx2reg: the
//            register organisation (reg4's: a barrier every four rows, two
//            shuffles a row instead of three).  The wrapper refuses a scoring
//            whose in-band values do not fit an int16 (dp_cell2.cuh).
//   clu*     one problem's lanes over a thread-block cluster of C = 2 or 4
//            blocks on neighbouring SMs (cudaLaunchKernelEx with a cluster
//            dimension): block c owns lanes [c S_t / C, (c + 1) S_t / C) and
//            runs the register organisation's row (reg's, or dpx2reg's for
//            dpx2clu*, one word a thread while a block holds at most 2,048
//            lanes: twice the warps to hide a row's latency).  All warps of
//            the cluster form one chain: warp g = c * warps + w runs g * N
//            rows behind warp 0, and a block's last lane sends its x, v and
//            query code through distributed shared memory into block c + 1's
//            inbound ring, so one cluster barrier every N = 32 rows orders
//            every seam (a ring of 4N slots: the 2N + 1 live rows of
//            tile_fill_cluster.cu's seam, rounded up to a power of two).  S_t
//            a multiple of 8 C, at most 4,096 lanes a block; a cluster the
//            card cannot hold is refused (cudaOccupancyMaxActiveClusters),
//            never shrunk.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "dp_cell.cuh"
#include "dp_cell2.cuh"
#include "fill_owned.cuh"

namespace cg = cooperative_groups;

namespace {

using sedef::LPT;
using sedef::Owned;
using sedef::Score;
using sedef::WILD;
using sedef::dp_cell;
using sedef::fill_owned;
using sedef::load_owned;
using sedef::own_row;
using sedef::pack_word;
using sedef::score_of;
using sedef::Score2;
using sedef::Q_WILD2;
using sedef::dir_bytes;
using sedef::dp_cell2;
using sedef::inject_top2;
using sedef::left_of;
using sedef::query_code2;
using sedef::score2;
using sedef::score_word;
using sedef::target_code2;

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// base
// ---------------------------------------------------------------------------

__global__ void fill_base(const int8_t* __restrict__ qseq,
                          const int8_t* __restrict__ tgt,
                          uint8_t* __restrict__ p, int S_q, int S_t,
                          Score s) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  const int b = blockIdx.x;
  int32_t* U = smem;
  int32_t* Y = smem + S_t;
  int32_t* X = smem + 2 * S_t;
  int32_t* V = smem + 4 * S_t;
  int8_t* ts = reinterpret_cast<int8_t*>(smem + 6 * S_t);
  int8_t* qs = ts + S_t;
  for (int k = threadIdx.x; k < S_t; k += blockDim.x)
    ts[k] = tgt[(size_t)b * S_t + k];
  for (int k = threadIdx.x; k < S_q; k += blockDim.x)
    qs[k] = qseq[(size_t)b * S_q + k];
  __syncthreads();
  const int n_rows = S_q + S_t - 1;
  uint8_t* pb = p + (size_t)b * n_rows * S_t;
  for (int r = 0; r < n_rows; ++r) {
    const int st0 = max(0, r - S_q + 1);
    const int en0 = min(r, S_t - 1);
    const int32_t* Xp = X + ((r & 1) ^ 1) * S_t;
    const int32_t* Vp = V + ((r & 1) ^ 1) * S_t;
    int32_t* Xc = X + (r & 1) * S_t;
    int32_t* Vc = V + (r & 1) * S_t;
    uint8_t* prow = pb + (size_t)r * S_t;
    for (int t = st0 + threadIdx.x; t <= en0; t += blockDim.x) {
      const int j = r - t;
      const int xs = t == 0 ? 0 : Xp[t - 1];
      const int vs = t == 0 ? (j > 0 ? s.gapo : 0) : Vp[t - 1];
      const int ub = j == 0 ? (t > 0 ? s.gapo : 0) : U[t];
      const int yb = j == 0 ? 0 : Y[t];
      const int qc = qs[j];
      const int tc = ts[t];
      const int sc =
          (qc >= WILD || tc >= WILD) ? 0 : (qc == tc ? s.match : s.mis);
      int un, vn, xn, yn;
      const int d = dp_cell(sc, xs, vs, ub, yb, s, un, vn, xn, yn);
      U[t] = un;
      Y[t] = yn;
      Vc[t] = vn;
      Xc[t] = xn;
      prow[t] = (uint8_t)d;
    }
    __syncthreads();
  }
}


// ---------------------------------------------------------------------------
// reg / regN / preg / pregN / bspec / bspecN: state in registers
// ---------------------------------------------------------------------------

// Per-thread carried state of the row before, for the four owned lanes.
// PACK: x holds the packed word, v and q are unused.
struct Carry {
  int u[LPT], y[LPT], x[LPT], v[LPT], q[LPT];
};

// Row r for one warp.  ``sin`` / ``sout``: the warp's inbound and outbound
// seam rings (``planes`` rings of ``ring`` ints each, ``ring`` a power of
// two); slot r & (ring - 1) of the outbound ring takes lane 31's last owned
// lane of row r.  FAST: r >= max(S_q, S_t), no boundary selects.
template <bool PACK, bool FAST>
__device__ __forceinline__ void reg_row(int r, int t0, int ln, int S_q,
                                        int S_t, const int8_t* qs,
                                        const int32_t* sin, int32_t* sout,
                                        int ring, const Owned& o, Carry& c,
                                        const Score& s, uint8_t* prow) {
  // lane t0 - 1 of the row before
  int xl = __shfl_up_sync(FULL, c.x[LPT - 1], 1);
  int vl = 0, ql = 0;
  if (!PACK) {
    vl = __shfl_up_sync(FULL, c.v[LPT - 1], 1);
    ql = __shfl_up_sync(FULL, c.q[LPT - 1], 1);
  }
  if (ln == 0) {
    const int slot = (r - 1) & (ring - 1);
    xl = sin[slot];
    if (!PACK) {
      vl = sin[ring + slot];
      ql = sin[2 * ring + slot];
    }
  }
  if (!FAST && t0 == 0) {  // lane -1: (x, v) = (0, j ? q : 0), code q[r]
    const int v0 = r > 0 ? s.gapo : 0;
    const int q0 = r < S_q ? qs[r] : WILD;
    if (PACK) {
      xl = pack_word(0, v0, q0);
    } else {
      xl = 0;
      vl = v0;
      ql = q0;
    }
  }
  uint32_t word = 0;
  // descending, so lane k - 1's registers still hold the row before
#pragma unroll
  for (int k = LPT - 1; k >= 0; --k) {
    const int km = k > 0 ? k - 1 : 0;
    const int src = k > 0 ? c.x[km] : xl;
    int qc, xs, vs;
    if (PACK) {
      qc = src >> 16;
      xs = src & 0xFF;
      vs = ((src >> 8) & 0xFF) - 128;
    } else {
      qc = k > 0 ? c.q[km] : ql;
      xs = src;
      vs = k > 0 ? c.v[km] : vl;
    }
    int ub = c.u[k], yb = c.y[k];
    if (!FAST && t0 + k == r) {  // top row: (u, y) = (t ? q : 0, 0)
      ub = t0 + k > 0 ? s.gapo : 0;
      yb = 0;
    }
    int un, vn, xn, yn;
    const int d =
        dp_cell(score_of(o, k, qc, s), xs, vs, ub, yb, s, un, vn, xn, yn);
    c.u[k] = un;
    c.y[k] = yn;
    if (PACK) {
      c.x[k] = pack_word(xn, vn, qc);
    } else {
      c.x[k] = xn;
      c.v[k] = vn;
      c.q[k] = qc;
    }
    word |= (uint32_t)d << (8 * k);
  }
  if (ln == 31) {
    const int slot = r & (ring - 1);
    sout[slot] = c.x[LPT - 1];
    if (!PACK) {
      sout[ring + slot] = c.v[LPT - 1];
      sout[2 * ring + slot] = c.q[LPT - 1];
    }
  }
  if (t0 < S_t) reinterpret_cast<uint32_t*>(prow)[t0 / LPT] = word;
}

template <bool PACK, bool BSPEC, int N>
__global__ void fill_reg(const int8_t* __restrict__ qseq,
                         const int8_t* __restrict__ tgt,
                         uint8_t* __restrict__ p, int S_q, int S_t, Score s) {
  extern __shared__ int4 smem4[];
  int32_t* seams = reinterpret_cast<int32_t*>(smem4);
  constexpr int PLANES = PACK ? 1 : 3;
  constexpr int RING = 4 * N;  // >= the 2 N + 1 rows in flight at a seam
  const int b = blockIdx.x;
  const int W = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int ln = threadIdx.x & 31;
  const int t0 = threadIdx.x * LPT;
  const int wl = w * 32 * LPT;  // the warp's first lane
  // ring set i is written by warp i - 1 and read by warp i; set 0 is
  // never written (lane 0's neighbour is the boundary injection)
  int8_t* qs = reinterpret_cast<int8_t*>(seams + (W + 1) * PLANES * RING);
  for (int k = threadIdx.x; k < (W + 1) * PLANES * RING; k += blockDim.x)
    seams[k] = 0;
  for (int k = threadIdx.x; k < S_q; k += blockDim.x)
    qs[k] = qseq[(size_t)b * S_q + k];
  const Owned o = load_owned(tgt + (size_t)b * S_t, t0, S_t);
  Carry c;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    c.u[k] = c.y[k] = c.v[k] = 0;
    c.x[k] = PACK ? pack_word(0, 0, WILD) : 0;
    c.q[k] = WILD;
  }
  __syncthreads();
  const int32_t* sin = seams + w * PLANES * RING;
  int32_t* sout = seams + (w + 1) * PLANES * RING;
  const int n_rows = S_q + S_t - 1;
  const int s_max = max(S_q, S_t);
  uint8_t* pb = p + (size_t)b * n_rows * S_t;
  // step st: warp w fills rows (st - w) * N .. + N - 1, so the seam values
  // of the row before were written by warp w - 1 one or two steps earlier
  const int n_steps = (n_rows + N - 1) / N + W - 1;
  for (int st = 0; st < n_steps; ++st) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (st - w) * N + i;
      // warp-uniform: rows of this problem whose band meets the warp's lanes
      if (r >= 0 && r < n_rows && wl <= r &&
          wl + 32 * LPT - 1 >= r - S_q + 1) {
        uint8_t* prow = pb + (size_t)r * S_t;
        if (BSPEC && r >= s_max)
          reg_row<PACK, true>(r, t0, ln, S_q, S_t, qs, sin, sout, RING, o, c,
                              s, prow);
        else
          reg_row<PACK, false>(r, t0, ln, S_q, S_t, qs, sin, sout, RING, o, c,
                               s, prow);
      }
    }
    if (W > 1) __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// dpx2 / dpx2u4: owned lanes, two lanes a word, state in shared memory
// ---------------------------------------------------------------------------

// The thread's WPT target code words: lanes (t0, t0 + 1), (t0 + 2, t0 +
// 3), ...
template <int WPT = 2>
__device__ __forceinline__ void load_targets2(const int8_t* __restrict__ tg,
                                              int t0, int S_t,
                                              unsigned (&tw)[WPT]) {
#pragma unroll
  for (int w = 0; w < WPT; ++w) {
    const int t = t0 + 2 * w;
    tw[w] = target_code2(t < S_t ? tg[t] : WILD) |
            target_code2(t + 1 < S_t ? tg[t + 1] : WILD) << 16;
  }
}

// Row r of the thread that owns lanes [t0, t0 + 4): words g2 = t0 / 2 and
// g2 + 1 of every plane (H words a plane).  ``par`` = r & 1 names the
// parity plane of x and v this row writes.  ``q``: the query code words of
// the thread's lanes in the row before; a code travels one lane a row, so a
// row loads one code, that of lane t0.  TOP: a lane of the warp may be on
// its top row.
template <bool TOP>
__device__ __forceinline__ void own_row2(int r, int par, int t0, int S_q,
                                         int H, uint32_t* U, uint32_t* Y,
                                         uint32_t* X, uint32_t* V,
                                         const uint8_t* qs,
                                         const unsigned (&tw)[2],
                                         const Score2& s2, int gapo,
                                         uint8_t* prow, unsigned (&q)[2]) {
  const int g = t0 / LPT;
  const uint32_t* Xp = X + (par ^ 1) * H;
  const uint32_t* Vp = V + (par ^ 1) * H;
  const uint2 u2 = reinterpret_cast<const uint2*>(U)[g];
  const uint2 y2 = reinterpret_cast<const uint2*>(Y)[g];
  const uint2 x2 = reinterpret_cast<const uint2*>(Xp)[g];
  const uint2 v2 = reinterpret_cast<const uint2*>(Vp)[g];
  // the word before the thread's: lane t0 - 1 in its high half
  unsigned xl = 0, vl = (unsigned)(r > 0 ? gapo : 0) << 16;  // lane -1
  if (t0 > 0) {
    xl = Xp[2 * g - 1];
    vl = Vp[2 * g - 1];
  }
  const int j = r - t0;  // >= 0 in a thread's rows
  q[1] = left_of(q[0], q[1]);
  q[0] = __byte_perm(j < S_q ? qs[j] : Q_WILD2, q[0], 0x5410);
  unsigned ub[2] = {u2.x, u2.y}, yb[2] = {y2.x, y2.y};
  if (TOP && (unsigned)j < (unsigned)LPT) inject_top2(j, t0, gapo, ub, yb);
  unsigned un[2], vn[2], xn[2], yn[2];
  const unsigned d0 =
      dp_cell2(score_word(q[0], tw[0], s2), left_of(xl, x2.x),
               left_of(vl, v2.x), ub[0], yb[0], s2, un[0], vn[0], xn[0],
               yn[0]);
  const unsigned d1 =
      dp_cell2(score_word(q[1], tw[1], s2), left_of(x2.x, x2.y),
               left_of(v2.x, v2.y), ub[1], yb[1], s2, un[1], vn[1], xn[1],
               yn[1]);
  reinterpret_cast<uint2*>(U)[g] = make_uint2(un[0], un[1]);
  reinterpret_cast<uint2*>(Y)[g] = make_uint2(yn[0], yn[1]);
  reinterpret_cast<uint2*>(X + par * H)[g] = make_uint2(xn[0], xn[1]);
  reinterpret_cast<uint2*>(V + par * H)[g] = make_uint2(vn[0], vn[1]);
  reinterpret_cast<uint32_t*>(prow)[g] = dir_bytes(d0, d1);
}

template <int UNROLL>
__global__ void fill_dpx2(const int8_t* __restrict__ qseq,
                          const int8_t* __restrict__ tgt,
                          uint8_t* __restrict__ p, int S_q, int S_t,
                          Score s) {
  extern __shared__ int4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int H = S_t / 2;  // words a plane
  uint32_t* U = smem;
  uint32_t* Y = smem + H;
  uint32_t* X = smem + 2 * H;
  uint32_t* V = smem + 4 * H;
  uint8_t* qs = reinterpret_cast<uint8_t*>(smem + 6 * H);
  const int b = blockIdx.x;
  const int t0 = threadIdx.x * LPT;
  for (int k = threadIdx.x; k < H; k += blockDim.x)
    U[k] = Y[k] = X[k] = X[H + k] = V[k] = V[H + k] = 0;
  for (int k = threadIdx.x; k < S_q; k += blockDim.x)
    qs[k] = (uint8_t)query_code2(qseq[(size_t)b * S_q + k]);
  unsigned tw[2];
  load_targets2(tgt + (size_t)b * S_t, t0, S_t, tw);
  unsigned q[2] = {Q_WILD2 * 0x10001u, Q_WILD2 * 0x10001u};
  const Score2 s2 = score2(s.match, s.mis, s.gapo, s.qe2);
  __syncthreads();
  const int n_rows = S_q + S_t - 1;
  uint8_t* pb = p + (size_t)b * n_rows * S_t;
  const int top_end = (int)(threadIdx.x & ~31u) * LPT + 32 * LPT;
  for (int rb = 0; rb < n_rows; rb += UNROLL) {
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int r = rb + i;
      const int par = i & 1;  // rb is even: the parity planes are fixed
      if (r < n_rows && t0 < S_t && t0 <= r && t0 + LPT - 1 >= r - S_q + 1) {
        uint8_t* prow = pb + (size_t)r * S_t;
        if (r < top_end)  // warp-uniform: a lane of the warp on its top row
          own_row2<true>(r, par, t0, S_q, H, U, Y, X, V, qs, tw, s2, s.gapo,
                         prow, q);
        else
          own_row2<false>(r, par, t0, S_q, H, U, Y, X, V, qs, tw, s2,
                          s.gapo, prow, q);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// dpx2reg / clu* / dpx2clu*: a chain of warps, state in registers, over a
// cluster of C blocks (C = 1: one block)
// ---------------------------------------------------------------------------

// Row r for one warp of the chain, the scalar cell (reg_row's, with the
// seam's sender and the store named by the caller).  ``sin`` / ``sout``:
// the inbound and outbound seam rings, planes x, v, code of ``ring`` slots.
template <bool TOP>
__device__ __forceinline__ void chain_row1(int r, int t0, int ln, int S_q,
                                           const uint8_t* qs,
                                           const int32_t* sin, int32_t* sout,
                                           bool send, int ring,
                                           const Owned& o, Carry& c,
                                           const Score& s, uint8_t* prow,
                                           bool store) {
  int xl = __shfl_up_sync(FULL, c.x[LPT - 1], 1);
  int vl = __shfl_up_sync(FULL, c.v[LPT - 1], 1);
  int ql = __shfl_up_sync(FULL, c.q[LPT - 1], 1);
  if (ln == 0) {
    const int slot = (r - 1) & (ring - 1);
    xl = sin[slot];
    vl = sin[ring + slot];
    ql = sin[2 * ring + slot];
  }
  if (t0 == 0) {  // lane -1: (x, v) = (0, j ? q : 0), code q[r]
    xl = 0;
    vl = r > 0 ? s.gapo : 0;
    ql = r < S_q ? qs[r] : WILD;
  }
  uint32_t word = 0;
  // descending, so lane k - 1's registers still hold the row before
#pragma unroll
  for (int k = LPT - 1; k >= 0; --k) {
    const int km = k > 0 ? k - 1 : 0;
    const int qc = k > 0 ? c.q[km] : ql;
    const int xs = k > 0 ? c.x[km] : xl;
    const int vs = k > 0 ? c.v[km] : vl;
    int ub = c.u[k], yb = c.y[k];
    if (TOP && t0 + k == r) {  // top row: (u, y) = (t ? q : 0, 0)
      ub = t0 + k > 0 ? s.gapo : 0;
      yb = 0;
    }
    int un, vn, xn, yn;
    const int d =
        dp_cell(score_of(o, k, qc, s), xs, vs, ub, yb, s, un, vn, xn, yn);
    c.u[k] = un;
    c.y[k] = yn;
    c.x[k] = xn;
    c.v[k] = vn;
    c.q[k] = qc;
    word |= (uint32_t)d << (8 * k);
  }
  if (send) {
    const int slot = r & (ring - 1);
    sout[slot] = c.x[LPT - 1];
    sout[ring + slot] = c.v[LPT - 1];
    sout[2 * ring + slot] = c.q[LPT - 1];
  }
  if (store) reinterpret_cast<uint32_t*>(prow)[t0 / LPT] = word;
}

// The thread's lanes as WPT words of each plane.
template <int WPT>
struct CarryW {
  unsigned u[WPT], y[WPT], x[WPT], v[WPT], q[WPT];
};

// Row r for one warp of the chain, the two-lanes-a-word cell, WPT words (2
// WPT lanes) a thread.  The seam rings have two planes: (x, v) of the
// sender's last lane as one word (x low, v high) and the word of its query
// code (the code in the high half).
template <bool TOP, int WPT>
__device__ __forceinline__ void chain_row2(int r, int t0, int ln, int S_q,
                                           const uint8_t* qs,
                                           const uint32_t* sin,
                                           uint32_t* sout, bool send,
                                           int ring,
                                           const unsigned (&tw)[WPT],
                                           CarryW<WPT>& c, const Score2& s2,
                                           int gapo, uint8_t* prow,
                                           bool store) {
  constexpr int L = 2 * WPT;
  // lane t0 - 1 of the row before: the high halves of the neighbour's last
  // words, x and v as one word
  unsigned xv = __shfl_up_sync(
      FULL, __byte_perm(c.x[WPT - 1], c.v[WPT - 1], 0x7632), 1);
  unsigned ql = __shfl_up_sync(FULL, c.q[WPT - 1], 1);
  if (ln == 0) {
    const int slot = (r - 1) & (ring - 1);
    xv = sin[slot];
    ql = sin[ring + slot];
  }
  if (t0 == 0) {  // lane -1: (x, v) = (0, j ? q : 0), code q[r]
    xv = (unsigned)(r > 0 ? gapo : 0) << 16;
    ql = (r < S_q ? (unsigned)qs[r] : Q_WILD2) << 16;
  }
  unsigned xs[WPT], vs[WPT], qw[WPT], ub[WPT], yb[WPT];
  xs[0] = __byte_perm(xv, c.x[0], 0x5410);
  vs[0] = __byte_perm(xv, c.v[0], 0x5432);
  qw[0] = left_of(ql, c.q[0]);
#pragma unroll
  for (int k = 1; k < WPT; ++k) {
    xs[k] = left_of(c.x[k - 1], c.x[k]);
    vs[k] = left_of(c.v[k - 1], c.v[k]);
    qw[k] = left_of(c.q[k - 1], c.q[k]);
  }
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    ub[k] = c.u[k];
    yb[k] = c.y[k];
  }
  if (TOP && (unsigned)(r - t0) < (unsigned)L)
    inject_top2<WPT>(r - t0, t0, gapo, ub, yb);
  unsigned d[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    d[k] = dp_cell2(score_word(qw[k], tw[k], s2), xs[k], vs[k], ub[k], yb[k],
                    s2, c.u[k], c.v[k], c.x[k], c.y[k]);
    c.q[k] = qw[k];
  }
  if (send) {
    const int slot = r & (ring - 1);
    sout[slot] = __byte_perm(c.x[WPT - 1], c.v[WPT - 1], 0x7632);
    sout[ring + slot] = c.q[WPT - 1];
  }
  if (store) {
    if constexpr (WPT == 2)
      *reinterpret_cast<uint32_t*>(prow + t0) = dir_bytes(d[0], d[1]);
    else
      *reinterpret_cast<uint16_t*>(prow + t0) =
          (uint16_t)__byte_perm(d[0], 0u, 0x0020);
  }
}

// Problem blockIdx.x / C over the C blocks of a cluster, S_t / C lanes a
// block, four a thread.  Ring set 0 of a block is its inbound seam from
// block c - 1 (written through distributed shared memory; never written in
// block 0, whose lane 0 takes the boundary injection), set w + 1 the seam
// from warp w to warp w + 1.  Warp g = c * warps + w fills rows (st - g) *
// N .. + N - 1 in step st, so the seam values of the row before were
// written a step earlier; one barrier a step (the cluster's, or the
// block's when C = 1) orders them.
template <bool DPX, int N, int LANES>
__global__ void __launch_bounds__(1024)
    fill_chain(const int8_t* __restrict__ qseq, const int8_t* __restrict__ tgt,
               uint8_t* __restrict__ p, int S_q, int S_t, Score s) {
  extern __shared__ int4 smem4[];
  int32_t* seams = reinterpret_cast<int32_t*>(smem4);
  constexpr int PLANES = DPX ? 2 : 3;
  constexpr int RING = 4 * N;  // >= the 2 N + 1 rows in flight at a seam
  constexpr int SET = PLANES * RING;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int Wl = S_t / C;  // lanes a block
  const int Wb = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int ln = threadIdx.x & 31;
  const int l0 = threadIdx.x * LANES;
  const int t0 = c * Wl + l0;
  const int g = c * Wb + w;                // the warp's place in the chain
  const int wl = c * Wl + w * 32 * LANES;    // the warp's first lane
  const bool mine = l0 < Wl;
  uint8_t* qs = reinterpret_cast<uint8_t*>(seams + (Wb + 1) * SET);
  for (int k = threadIdx.x; k < (Wb + 1) * SET; k += blockDim.x)
    seams[k] = 0;
  if (c == 0)
    for (int k = threadIdx.x; k < S_q; k += blockDim.x)
      qs[k] = (uint8_t)query_code2(qseq[(size_t)b * S_q + k]);
  const int32_t* sin = seams + w * SET;
  int32_t* sout = seams + (w + 1) * SET;
  bool send = ln == 31 && w < Wb - 1;
  if (w == Wb - 1 && c < C - 1) {  // into block c + 1's inbound set
    sout = cluster.map_shared_rank(seams, c + 1);
    send = l0 == Wl - LANES;
  }
  const int8_t* tg = tgt + (size_t)b * S_t;
  constexpr int WPT = LANES / 2;
  Owned o;
  unsigned tw[WPT];
  Carry c1;
  CarryW<WPT> c2;
  if constexpr (DPX) {
    load_targets2<WPT>(tg, t0, S_t, tw);
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
      c2.u[k] = c2.y[k] = c2.x[k] = c2.v[k] = 0;
      c2.q[k] = Q_WILD2 * 0x10001u;
    }
  } else {
    o = load_owned(tg, t0, S_t);
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      c1.u[k] = c1.y[k] = c1.x[k] = c1.v[k] = 0;
      c1.q[k] = WILD;
    }
  }
  const Score2 s2 = score2(s.match, s.mis, s.gapo, s.qe2);
  // every block of the cluster runs before any writes into a neighbour
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();
  const int n_rows = S_q + S_t - 1;
  uint8_t* pb = p + (size_t)b * n_rows * S_t;
  const int n_steps = (n_rows + N - 1) / N + C * Wb - 1;
  // the rows of a step: unrolled four at a time past eight (the two row
  // bodies, N times over, would outgrow the instruction cache)
  constexpr int UNROLL = N > 8 ? 4 : N;
  for (int st = 0; st < n_steps; ++st) {
#pragma unroll UNROLL
    for (int i = 0; i < N; ++i) {
      const int r = (st - g) * N + i;
      // warp-uniform: rows of this problem whose band meets the warp's lanes
      if (r >= 0 && r < n_rows && wl <= r &&
          wl + 32 * LANES - 1 >= r - S_q + 1) {
        uint8_t* prow = pb + (size_t)r * S_t;
        const bool top = r < wl + 32 * LANES;
        if constexpr (DPX) {
          const uint32_t* in = reinterpret_cast<const uint32_t*>(sin);
          uint32_t* out = reinterpret_cast<uint32_t*>(sout);
          if (top)
            chain_row2<true, WPT>(r, t0, ln, S_q, qs, in, out, send, RING, tw, c2,
                             s2, s.gapo, prow, mine);
          else
            chain_row2<false, WPT>(r, t0, ln, S_q, qs, in, out, send, RING, tw,
                              c2, s2, s.gapo, prow, mine);
        } else {
          if (top)
            chain_row1<true>(r, t0, ln, S_q, qs, sin, sout, send, RING, o, c1,
                             s, prow, mine);
          else
            chain_row1<false>(r, t0, ln, S_q, qs, sin, sout, send, RING, o,
                              c1, s, prow, mine);
        }
      }
    }
    if (C > 1)
      cluster.sync();
    else if (Wb > 1)
      __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------

enum Org { ORG_BASE, ORG_OWNED, ORG_REG, ORG_OWNED2, ORG_CHAIN };

struct Variant {
  const char* name;
  Org org;
  bool pack, bspec;
  int n;  // rows per unrolled step (owned) or per barrier (reg, chain)
  bool vib = false;  // the cell with __vibmax_s32 (owned, two rows a step)
  bool dpx = false;  // the two-lanes-a-word cell (dp_cell2.cuh)
  int C = 1;         // blocks a problem (chain)
};

const Variant VARIANTS[] = {
    {"base", ORG_BASE, false, false, 1},
    {"hoist", ORG_OWNED, false, false, 1},
    {"unroll2", ORG_OWNED, false, false, 2},
    {"unroll4", ORG_OWNED, false, false, 4},
    {"pack", ORG_OWNED, true, false, 1},
    {"packu2", ORG_OWNED, true, false, 2},
    {"packu4", ORG_OWNED, true, false, 4},
    {"reg", ORG_REG, false, false, 1},
    {"reg2", ORG_REG, false, false, 2},
    {"reg4", ORG_REG, false, false, 4},
    {"preg", ORG_REG, true, false, 1},
    {"preg2", ORG_REG, true, false, 2},
    {"preg4", ORG_REG, true, false, 4},
    {"bspec", ORG_REG, false, true, 1},
    {"bspec2", ORG_REG, false, true, 2},
    {"bspec4", ORG_REG, false, true, 4},
    {"vibmax", ORG_OWNED, false, false, 2, true},
    {"dpx2", ORG_OWNED2, false, false, 2, false, true},
    {"dpx2u4", ORG_OWNED2, false, false, 4, false, true},
    {"dpx2reg", ORG_CHAIN, false, false, 4, false, true, 1},
    {"clu2", ORG_CHAIN, false, false, 32, false, false, 2},
    {"clu4", ORG_CHAIN, false, false, 32, false, false, 4},
    {"dpx2clu2", ORG_CHAIN, false, false, 32, false, true, 2},
    {"dpx2clu4", ORG_CHAIN, false, false, 32, false, true, 4},
};
constexpr int N_VARIANTS = sizeof(VARIANTS) / sizeof(VARIANTS[0]);

constexpr long long SMEM_MAX = 227LL * 1024;

struct Args {
  const int8_t* q;
  const int8_t* t;
  uint8_t* p;
  int B, S_q, S_t;
  Score s;
  cudaStream_t cs;
};

template <typename Kernel>
int launch(Kernel kernel, const Args& a, int threads, long long smem) {
  if (smem > SMEM_MAX || threads < 1 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<a.B, threads, (size_t)smem, a.cs>>>(a.q, a.t, a.p, a.S_q, a.S_t,
                                                a.s);
  return (int)cudaGetLastError();
}

template <bool PACK>
int launch_owned(const Args& a, int n, int threads) {
  const long long smem = (PACK ? 16LL : 24LL) * a.S_t + a.S_q;
  switch (n) {
    case 1: return launch(fill_owned<PACK, 1>, a, threads, smem);
    case 2: return launch(fill_owned<PACK, 2>, a, threads, smem);
    default: return launch(fill_owned<PACK, 4>, a, threads, smem);
  }
}

template <bool PACK, bool BSPEC>
int launch_reg(const Args& a, int n, int threads) {
  const long long seam = (threads / 32 + 1) * (PACK ? 1LL : 3LL) * 4 * n * 4;
  const long long smem = seam + a.S_q;
  switch (n) {
    case 1: return launch(fill_reg<PACK, BSPEC, 1>, a, threads, smem);
    case 2: return launch(fill_reg<PACK, BSPEC, 2>, a, threads, smem);
    default: return launch(fill_reg<PACK, BSPEC, 4>, a, threads, smem);
  }
}

// The chain kernel of a variant, its block and its shared memory.
struct Chain {
  void (*kernel)(const int8_t*, const int8_t*, uint8_t*, int, int, Score);
  int threads;
  long long smem;
};

// Lanes a thread of a chain: two (one word) for the word cell over a
// cluster while a block holds at most 2,048 lanes, else four.
int chain_lanes(const Variant& v, int S_t) {
  return v.dpx && v.C > 1 && S_t / v.C <= 512 * LPT ? 2 : LPT;
}

Chain chain_of(const Variant& v, int S_q, int S_t) {
  const int lanes = chain_lanes(v, S_t);
  const int threads = (S_t / v.C / lanes + 31) / 32 * 32;
  const long long smem =
      (threads / 32 + 1) * (v.dpx ? 2LL : 3LL) * 4 * v.n * 4 + S_q;
  auto kernel = !v.dpx       ? fill_chain<false, 32, LPT>
                : v.n == 4   ? fill_chain<true, 4, LPT>
                : lanes == 2 ? fill_chain<true, 32, 2>
                             : fill_chain<true, 32, LPT>;
  return {kernel, threads, smem};
}

int chain_config(const Variant& v, const Chain& ch, int B, cudaStream_t cs,
                 cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (ch.smem > SMEM_MAX || ch.threads < 1 || ch.threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ch.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ch.smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused shape must not fail the next launch
    return (int)e;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(B * v.C));
  cfg->blockDim = dim3((unsigned)ch.threads);
  cfg->dynamicSmemBytes = (size_t)ch.smem;
  cfg->stream = cs;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)v.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// Clusters of the variant's shape the card holds at once, remembered per
// (kernel, cluster, block, shared memory) for the process.
int chain_clusters(const Variant& v, const Chain& ch, int B, int* out) {
  static std::mutex mu;
  static struct {
    const void* kernel;
    int C, threads;
    long long smem;
    int n;
  } seen[64];
  static int n_seen = 0;
  if (ch.smem > SMEM_MAX) {  // a block no SM can hold
    *out = 0;
    return 0;
  }
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == (const void*)ch.kernel && seen[i].C == v.C &&
        seen[i].threads == ch.threads && seen[i].smem == ch.smem) {
      *out = seen[i].n;
      return 0;
    }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc = chain_config(v, ch, B, nullptr, &cfg, &attr);
  if (rc) return rc;
  cudaError_t e = cudaOccupancyMaxActiveClusters(out, ch.kernel, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  if (n_seen < 64)
    seen[n_seen++] = {(const void*)ch.kernel, v.C, ch.threads, ch.smem, *out};
  return 0;
}

int launch_chain(const Variant& v, const Args& a) {
  const Chain ch = chain_of(v, a.S_q, a.S_t);
  int held = 0;
  int rc = chain_clusters(v, ch, a.B, &held);
  if (rc) return rc;
  if (held < 1) return (int)cudaErrorInvalidConfiguration;  // never shrunk
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  rc = chain_config(v, ch, a.B, a.cs, &cfg, &attr);
  if (rc) return rc;
  cudaError_t e = cudaLaunchKernelEx(&cfg, ch.kernel, a.q, a.t, a.p, a.S_q,
                                     a.S_t, a.s);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch must not fail the next one
    return (int)e;
  }
  return (int)cudaGetLastError();
}

const Variant* find_variant(const char* name) {
  for (int i = 0; i < N_VARIANTS; ++i)
    if (strcmp(VARIANTS[i].name, name) == 0) return &VARIANTS[i];
  return nullptr;
}

// The class width the variant takes: the owned-lane rule of every variant
// but base; over a cluster a whole number of 8-lane groups a block and at
// most 4,096 lanes a block.
bool takes(const Variant& v, int S_t) {
  if (v.org == ORG_BASE) return true;
  const int unit = v.C > 1 ? 8 * v.C : LPT;
  return S_t % unit == 0 && S_t <= 1024 * LPT * v.C;
}

// The scoring the variant takes: eight bits of state (pack*), the word
// cell's int16 and int8 ranges (dpx2*).
bool takes_scoring(const Variant& v, const Score& s) {
  if (v.pack && s.max_sc > 127) return false;
  return !v.dpx ||
         sedef::score2_fits(s.match, s.mis, s.gapo, s.qe2 / 2 - s.gapo);
}

}  // namespace

// ---------------------------------------------------------------------------
// SASS probes: one row body each, in a loop that is never unrolled; never
// launched.  tools/kbench.py (sass_counts) reads the instructions of each
// loop from the built library, so the row's own instructions a cell are
// counted without the launch's set-up or its rows' other bodies.
// ---------------------------------------------------------------------------

extern "C" __global__ void sedef_probe_owned(const int8_t* tgt, uint8_t* p,
                                             int r0, int r1, int S_q,
                                             int S_t, Score s) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  const int t0 = threadIdx.x * LPT;
  const Owned o = load_owned(tgt, t0, S_t);
  int qt[LPT] = {WILD, WILD, WILD, WILD};
#pragma unroll 1
  for (int r = r0; r < r1; ++r)
    own_row<false, false, false>(r, r & 1, t0, S_q, S_t, smem, smem + S_t,
                                 smem + 2 * S_t, smem + 4 * S_t,
                                 reinterpret_cast<int8_t*>(smem + 6 * S_t),
                                 o, s, p + (size_t)r * S_t, qt);
}

extern "C" __global__ void sedef_probe_owned2(const int8_t* tgt, uint8_t* p,
                                              int r0, int r1, int S_q,
                                              int S_t, Score s) {
  extern __shared__ int4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int H = S_t / 2;
  const int t0 = threadIdx.x * LPT;
  unsigned tw[2];
  load_targets2(tgt, t0, S_t, tw);
  unsigned q[2] = {0, 0};
  const Score2 s2 = score2(s.match, s.mis, s.gapo, s.qe2);
#pragma unroll 1
  for (int r = r0; r < r1; ++r)
    own_row2<false>(r, r & 1, t0, S_q, H, smem, smem + H, smem + 2 * H,
                    smem + 4 * H, reinterpret_cast<uint8_t*>(smem + 6 * H),
                    tw, s2, s.gapo, p + (size_t)r * S_t, q);
}

extern "C" __global__ void sedef_probe_reg(const int8_t* tgt, uint8_t* p,
                                           int r0, int r1, int S_q, int S_t,
                                           Score s) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  const int t0 = threadIdx.x * LPT;
  const Owned o = load_owned(tgt, t0, S_t);
  Carry c = {};
#pragma unroll 1
  for (int r = r0; r < r1; ++r)
    reg_row<false, false>(r, t0, threadIdx.x & 31, S_q, S_t,
                          reinterpret_cast<int8_t*>(smem + 64), smem,
                          smem + 32, 8, o, c, s, p + (size_t)r * S_t);
}

extern "C" __global__ void sedef_probe_chain1(const int8_t* tgt, uint8_t* p,
                                              int r0, int r1, int S_q,
                                              int S_t, Score s) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  const int t0 = threadIdx.x * LPT;
  const Owned o = load_owned(tgt, t0, S_t);
  Carry c = {};
  const bool send = (threadIdx.x & 31) == 31;
#pragma unroll 1
  for (int r = r0; r < r1; ++r)
    chain_row1<false>(r, t0, threadIdx.x & 31, S_q,
                      reinterpret_cast<uint8_t*>(smem + 128), smem,
                      smem + 64, send, 32, o, c, s, p + (size_t)r * S_t,
                      t0 < S_t);
}

extern "C" __global__ void sedef_probe_chain2(const int8_t* tgt, uint8_t* p,
                                              int r0, int r1, int S_q,
                                              int S_t, Score s) {
  extern __shared__ int4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int t0 = threadIdx.x * LPT;
  unsigned tw[2];
  load_targets2(tgt, t0, S_t, tw);
  CarryW<2> c = {};
  const Score2 s2 = score2(s.match, s.mis, s.gapo, s.qe2);
  const bool send = (threadIdx.x & 31) == 31;
#pragma unroll 1
  for (int r = r0; r < r1; ++r)
    chain_row2<false, 2>(r, t0, threadIdx.x & 31, S_q,
                      reinterpret_cast<uint8_t*>(smem + 128), smem,
                      smem + 64, send, 32, tw, c, s2, s.gapo,
                      p + (size_t)r * S_t, t0 < S_t);
}

extern "C" {

// The variants' names, in order; nullptr past the end.
const char* sedef_fill_variant_name(int i) {
  return i >= 0 && i < N_VARIANTS ? VARIANTS[i].name : nullptr;
}

// The direct fill under ``variant``.  qseq (B, S_q) int8, tgt (B, S_t) int8
// (wildcard 4 padded), p (B, S_q + S_t - 1, S_t) uint8.  ``base_threads``
// is the block size of ``base``; the owned-lane variants use one thread
// per four lanes.  Launches on ``stream`` without synchronising.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown name or a
// shape the variant does not take.
int sedef_fill_variant(const char* variant, const void* qseq, const void* tgt,
                       void* p, int B, int S_q, int S_t, int match, int mis,
                       int gapo, int gape, int base_threads, void* stream) {
  const Variant* v = find_variant(variant);
  if (v == nullptr || S_q < 1 || S_t < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const int qe2 = 2 * (gapo + gape);
  const Args a = {static_cast<const int8_t*>(qseq),
                  static_cast<const int8_t*>(tgt),
                  static_cast<uint8_t*>(p),
                  B,
                  S_q,
                  S_t,
                  {match, mis, gapo, qe2, match + qe2},
                  static_cast<cudaStream_t>(stream)};
  if (v->org == ORG_BASE)
    return launch(fill_base, a, base_threads, 25LL * S_t + S_q);
  if (!takes(*v, S_t) || !takes_scoring(*v, a.s))
    return (int)cudaErrorInvalidValue;
  if (v->org == ORG_CHAIN) return launch_chain(*v, a);
  const int threads = (S_t / LPT + 31) / 32 * 32;
  if (v->org == ORG_OWNED2)
    return v->n == 2 ? launch(fill_dpx2<2>, a, threads, 12LL * S_t + S_q)
                     : launch(fill_dpx2<4>, a, threads, 12LL * S_t + S_q);
  if (v->vib)
    return launch(fill_owned<false, 2, true>, a, threads,
                  24LL * a.S_t + a.S_q);
  if (v->org == ORG_OWNED)
    return v->pack ? launch_owned<true>(a, v->n, threads)
                   : launch_owned<false>(a, v->n, threads);
  if (v->pack) return launch_reg<true, false>(a, v->n, threads);
  return v->bspec ? launch_reg<false, true>(a, v->n, threads)
                  : launch_reg<false, false>(a, v->n, threads);
}

// Clusters of ``variant``'s shape at (S_q, S_t) that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out: 0 means a launch would be
// refused.  Returns a CUDA error code; cudaErrorInvalidValue for a name
// that launches no chain of warps, or a class the variant does not take.
int sedef_fill_variant_clusters(const char* variant, int S_q, int S_t,
                                int* out) {
  const Variant* v = find_variant(variant);
  if (v == nullptr || v->org != ORG_CHAIN || S_q < 1 || S_t < 1 ||
      !takes(*v, S_t))
    return (int)cudaErrorInvalidValue;
  return chain_clusters(*v, chain_of(*v, S_q, S_t), 1, out);
}

}  // extern "C"
