// The direct fill of the anti-diagonal affine-gap DP under a family of
// implementations of the same recurrence: the variant harness.
//
// Replaces make_kernel / run of tools/kbench.py (the TPU experiment
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
// anti-diagonal).
// The owned-lane variants take both on: four cells per thread between
// synchronisations, a quarter of the store instructions, and in reg no
// shared-memory traffic for the state at all.  The strict '>' tests in
// order and then the clamp decide the direction byte in every variant.
//
// The owned-lane variants take S_t a multiple of 4 up to 4096 (1024
// threads of 4 lanes); all variants keep their state in shared memory or
// registers, so a class must fit 227 KB.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "dp_cell.cuh"
#include "fill_owned.cuh"

namespace {

using sedef::LPT;
using sedef::Owned;
using sedef::Score;
using sedef::WILD;
using sedef::dp_cell;
using sedef::fill_owned;
using sedef::load_owned;
using sedef::pack_word;
using sedef::score_of;

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
// Dispatch
// ---------------------------------------------------------------------------

enum Org { ORG_BASE, ORG_OWNED, ORG_REG };

struct Variant {
  const char* name;
  Org org;
  bool pack, bspec;
  int n;  // rows per unrolled step (owned) or per barrier (reg)
  bool vib = false;  // the cell with __vibmax_s32 (owned, two rows a step)
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

}  // namespace

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
  const Variant* v = nullptr;
  for (int i = 0; i < N_VARIANTS; ++i)
    if (strcmp(VARIANTS[i].name, variant) == 0) v = &VARIANTS[i];
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
  if (S_t % LPT || S_t > 1024 * LPT) return (int)cudaErrorInvalidValue;
  if (v->pack && a.s.max_sc > 127) return (int)cudaErrorInvalidValue;
  const int threads = (S_t / LPT + 31) / 32 * 32;
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

}  // extern "C"
