// The owned-lane fill of the anti-diagonal affine-gap DP: one block per
// problem, every thread owns four neighbouring lanes for the whole problem.
// Shared by the direct fill (sedef_fill_owned of wavefront_fill.cu, the
// organisation fill_plan of sedef_tpu_torch/ops/wavefront.py calls "owned"),
// the streamed fill (sedef_fill_streamed, the same block per problem written
// into the stream layout: fill_owned_streamed) and the variant harness
// (hoist, unrollN, pack, packuN and vibmax of wavefront_fill_variants.cu,
// which describes them).  The recurrence is the one in the docstring of
// sedef_tpu_torch/ops/wavefront.py.
//
// Stream mode (STREAM).  Problem b = s * K + k writes its direction row r at
// stream row k * S_q + r of stream s, the stream's rows (K * S_q + S_t - 1,
// S_t) as wavefront_fill.cu lays them out.  Problem k's band there, lanes t
// with 0 <= r - t < S_q, shares its rows with the bands of problems k - 1
// and k + 1, which other blocks fill at the same time.  So a thread stores
// only its own band bytes: one 32-bit word in the rows in which all four of
// its lanes are in the band (LPT - 1 <= r - t0 < S_q), each in-band byte
// alone in the rows in which its group meets the band partly (r - t0 in
// [0, LPT - 2] and [S_q, S_q + LPT - 2]: about six rows a group).  Byte
// stores from different blocks to different bytes do not race; a word
// store there would overwrite a neighbour's byte.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_cell.cuh"

namespace sedef {
namespace {  // a copy per translation unit, as the kernels are launched by name

constexpr int LPT = 4;  // lanes a thread owns

__device__ __forceinline__ int pack_word(int x, int v, int q) {
  return (q << 16) | ((v + 128) << 8) | x;
}

// dp_cell with each max-and-test pair as one __vibmax_s32: the same values
// and the same byte.
__device__ __forceinline__ int dp_cell_vibmax(int sc, int xs, int vs, int ub,
                                              int yb, const Score& s, int& u,
                                              int& v, int& x, int& y) {
  bool ge;  // z >= a: the complement of the strict test a > z
  int z = sc + s.qe2;
  const int a = xs + vs;
  const int b = yb + ub;
  z = __vibmax_s32(z, a, &ge);
  int d = ge ? 0 : 1;
  z = __vibmax_s32(z, b, &ge);
  d = ge ? d : 2;
  z = min(z, s.max_sc);
  const int z2 = z - s.gapo;
  const int a2 = a - z2;
  const int b2 = b - z2;
  u = z - vs;
  v = z - ub;
  x = max(a2, 0);
  y = max(b2, 0);
  return d | (a2 > 0 ? 8 : 0) | (b2 > 0 ? 16 : 0);
}

// ---------------------------------------------------------------------------
// Owned lanes: target codes of a thread's four lanes, in registers
// ---------------------------------------------------------------------------

struct Owned {
  int tc[LPT];
  bool tw[LPT];
};

__device__ __forceinline__ Owned load_owned(const int8_t* __restrict__ tg,
                                            int t0, int S_t) {
  Owned o;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    o.tc[k] = t0 + k < S_t ? tg[t0 + k] : WILD;
    o.tw[k] = o.tc[k] >= WILD;
  }
  return o;
}

__device__ __forceinline__ int score_of(const Owned& o, int k, int qc,
                                        const Score& s) {
  return (o.tw[k] || (unsigned)qc >= (unsigned)WILD)
             ? 0
             : (qc == o.tc[k] ? s.match : s.mis);
}

// ---------------------------------------------------------------------------
// hoist / unrollN / pack / packuN: state in shared memory, lanes owned
// ---------------------------------------------------------------------------

// Row r of the thread that owns lanes [t0, t0 + 4).  ``par`` = r & 1 names
// the parity plane this row writes; it reads the other one.  PACK: plane P
// holds the packed word and V is unused.  VIB: the cell is dp_cell_vibmax.
// ``qt``: the query codes of the thread's lanes in the row before (the
// wildcard before the thread's first row); a code travels with its
// diagonal, one lane a row, so a row loads one code, that of lane t0.  A
// thread's rows are consecutive, so nothing is lost between them.
template <bool PACK, bool VIB, bool STREAM>
__device__ __forceinline__ void own_row(int r, int par, int t0, int S_q,
                                        int S_t, int32_t* U, int32_t* Y,
                                        int32_t* P, int32_t* V,
                                        const int8_t* qs, const Owned& o,
                                        const Score& s, uint8_t* prow,
                                        int (&qt)[LPT]) {
  const int g = t0 / LPT;
  const int32_t* Pp = P + (par ^ 1) * S_t;
  const int32_t* Vp = V + (par ^ 1) * S_t;
  const int4 u4 = reinterpret_cast<const int4*>(U)[g];
  const int4 y4 = reinterpret_cast<const int4*>(Y)[g];
  const int4 p4 = reinterpret_cast<const int4*>(Pp)[g];
  const int ub4[LPT] = {u4.x, u4.y, u4.z, u4.w};
  const int yb4[LPT] = {y4.x, y4.y, y4.z, y4.w};
  // lane t - 1 of the row before, for the four lanes
  int pl[LPT] = {0, p4.x, p4.y, p4.z};
  int vl[LPT] = {0, 0, 0, 0};
  if (!PACK) {
    const int4 v4 = reinterpret_cast<const int4*>(Vp)[g];
    vl[1] = v4.x;
    vl[2] = v4.y;
    vl[3] = v4.z;
  }
  if (!PACK) {
#pragma unroll
    for (int k = LPT - 1; k > 0; --k) qt[k] = qt[k - 1];
    qt[0] = r - t0 < S_q ? qs[r - t0] : WILD;  // r >= t0 in a thread's rows
  }
  const int v0 = r > 0 ? s.gapo : 0;  // lane -1: (x, v) = (0, j ? q : 0)
  if (t0 == 0) {
    if (PACK)
      pl[0] = pack_word(0, v0, r < S_q ? qs[r] : WILD);
    else
      vl[0] = v0;
  } else {
    pl[0] = Pp[t0 - 1];
    if (!PACK) vl[0] = Vp[t0 - 1];
  }
  int un[LPT], yn[LPT], pn[LPT], vn[LPT];
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int t = t0 + k;
    int qc, xs, vs;
    if (PACK) {
      qc = pl[k] >> 16;
      xs = pl[k] & 0xFF;
      vs = ((pl[k] >> 8) & 0xFF) - 128;
    } else {
      qc = qt[k];
      xs = pl[k];
      vs = vl[k];
    }
    int ub = ub4[k], yb = yb4[k];
    if (t == r) {  // top row: (u, y) = (t ? q : 0, 0)
      ub = t > 0 ? s.gapo : 0;
      yb = 0;
    }
    int xn;
    const int sc = score_of(o, k, qc, s);
    const int d = VIB ? dp_cell_vibmax(sc, xs, vs, ub, yb, s, un[k], vn[k],
                                       xn, yn[k])
                      : dp_cell(sc, xs, vs, ub, yb, s, un[k], vn[k], xn,
                                yn[k]);
    pn[k] = PACK ? pack_word(xn, vn[k], qc) : xn;
    word |= (uint32_t)d << (8 * k);
  }
  reinterpret_cast<int4*>(U)[g] = make_int4(un[0], un[1], un[2], un[3]);
  reinterpret_cast<int4*>(Y)[g] = make_int4(yn[0], yn[1], yn[2], yn[3]);
  reinterpret_cast<int4*>(P + par * S_t)[g] =
      make_int4(pn[0], pn[1], pn[2], pn[3]);
  if (!PACK)
    reinterpret_cast<int4*>(V + par * S_t)[g] =
        make_int4(vn[0], vn[1], vn[2], vn[3]);
  if (STREAM && !(r - t0 >= LPT - 1 && r - t0 < S_q)) {
    // the group meets the band partly: the word's other bytes are the
    // stream's neighbouring problems'
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if ((unsigned)(r - t0 - k) < (unsigned)S_q)
        prow[t0 + k] = (uint8_t)(word >> (8 * k));
  } else {
    reinterpret_cast<uint32_t*>(prow)[g] = word;
  }
}

// The block of problem blockIdx.x.  STREAM: problems come in streams of
// ``K`` (see above); otherwise problem b's rows start at b * (S_q + S_t - 1).
template <bool PACK, int UNROLL, bool VIB, bool STREAM>
__device__ __forceinline__ void owned_block(const int8_t* __restrict__ qseq,
                                            const int8_t* __restrict__ tgt,
                                            uint8_t* __restrict__ p, int S_q,
                                            int S_t, const Score& s, int K) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  const int b = blockIdx.x;
  const int t0 = threadIdx.x * LPT;
  int32_t* U = smem;
  int32_t* Y = smem + S_t;
  int32_t* P = smem + 2 * S_t;                   // x, or the packed word
  int32_t* V = PACK ? P : smem + 4 * S_t;        // unused when PACK
  int8_t* qs = reinterpret_cast<int8_t*>(smem + (PACK ? 4 : 6) * S_t);
  for (int k = threadIdx.x; k < S_t; k += blockDim.x) {
    U[k] = 0;
    Y[k] = 0;
    P[k] = P[S_t + k] = PACK ? pack_word(0, 0, WILD) : 0;
    if (!PACK) V[k] = V[S_t + k] = 0;
  }
  for (int k = threadIdx.x; k < S_q; k += blockDim.x)
    qs[k] = qseq[(size_t)b * S_q + k];
  const Owned o = load_owned(tgt + (size_t)b * S_t, t0, S_t);
  int qt[LPT] = {WILD, WILD, WILD, WILD};
  __syncthreads();
  const int n_rows = S_q + S_t - 1;
  const size_t row0 =
      STREAM ? (size_t)(b / K) * (K * S_q + S_t - 1) + (size_t)(b % K) * S_q
             : (size_t)b * n_rows;
  uint8_t* pb = p + row0 * S_t;
  for (int rb = 0; rb < n_rows; rb += UNROLL) {
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int r = rb + i;
      // rb is a multiple of UNROLL, so an even UNROLL fixes the parity
      const int par = UNROLL % 2 == 0 ? (i & 1) : (r & 1);
      if (r < n_rows && t0 < S_t && t0 <= r && t0 + LPT - 1 >= r - S_q + 1)
        own_row<PACK, VIB, STREAM>(r, par, t0, S_q, S_t, U, Y, P, V, qs, o,
                                   s, pb + (size_t)r * S_t, qt);
      __syncthreads();
    }
  }
}

template <bool PACK, int UNROLL, bool VIB = false>
__global__ void fill_owned(const int8_t* __restrict__ qseq,
                           const int8_t* __restrict__ tgt,
                           uint8_t* __restrict__ p, int S_q, int S_t,
                           Score s) {
  owned_block<PACK, UNROLL, VIB, false>(qseq, tgt, p, S_q, S_t, s, 1);
}

// n_streams * K blocks, problem b = s * K + k into stream s at row k * S_q
template <int UNROLL>
__global__ void fill_owned_streamed(const int8_t* __restrict__ qseq,
                                    const int8_t* __restrict__ tgt,
                                    uint8_t* __restrict__ p, int S_q,
                                    int S_t, Score s, int K) {
  owned_block<false, UNROLL, false, true>(qseq, tgt, p, S_q, S_t, s, K);
}

}  // namespace
}  // namespace sedef
