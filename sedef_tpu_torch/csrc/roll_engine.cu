// The stage-1 roll engine: interval rolls, every step of every interval
// inside one launch (a chromosome pair's intervals of both T classes in
// one call).
//
// Replaces _roll_batch (sedef_tpu/ops/roll_engine.py:143), a jit program
// whose two loops are lax.fori_loops; its plain PyTorch version is
// _roll_batch_torch in ops/roll_engine.py, which this kernel follows
// branch for branch.  Each interval replays the op stream of the
// reference's roll (search.cc:289-315) on its own sliding sketch: one
// sorted row of W int32 entries ``key << 2 | flags`` (query = 1, ref = 2),
// INF-padded past its ``ln`` live entries, with the boundary index Bp,
// the path-dependent intersection counter and the quirks of SlidingJaccard
// (ops/sliding.py), kept exactly:
//   - the boundary branch runs after the physical insert and before the
//     physical erase;
//   - a key equal to the boundary element is not counted (sliding.cc:86);
//   - HAS_N ref keys ((h >> 2k) == 2) are skipped, their cursor moves on;
//   - an insert into a full row (ln >= W) sets ``ovf`` and the step goes
//     on;
//   - an empty query window starts with Bp = -1: a negative Bp indexes the
//     row from its end, as the reference's take_along_axis does, and one
//     below -W reads INT32_MIN (take1).
//
// What bounds it on the H100: nothing the card can run wide.  An interval
// is one dependent chain of some 2 * n_steps + init_cnt sketch updates (a
// conditional remove and add a step), each a search of the sorted row, a
// shift of its tail and a read of the boundary entry; a chromosome pair
// gives a few thousand such chains.  The bytes (the plan, the minimizer
// arrays read once) and the operations are far below what the chains'
// latency costs, so the design shortens the chain of an update.
//
// What the design does about it: a warp an interval, its row in
// registers, lane-major (W = 32 E, lane l holds entries [E l, E l + E);
// E a template parameter, 16 and 2 built), its scalars the same in every
// lane.
//   - The place of a key is E independent compares a lane and one
//     __reduce_add_sync: its cost does not depend on the place.
//   - An entry is read by a select tree on the bits of its (warp-uniform)
//     index inside its lane and one __shfl_sync from the owning lane; the
//     registers are never indexed at run time, so nothing goes to local
//     memory.
//   - An insert or an erase is an E-wide select shift inside each lane,
//     the carry from the neighbouring lane by __shfl_up_sync or
//     __shfl_down_sync, issued before the search (the carry does not
//     depend on the place).
//     No shared memory and no __syncwarp on the chain.
//   - The boundary entry is read from the row before the update, beside
//     the search: an erase reads take1(row, Bp) and take1(row, Bp + 1)
//     there, as the reference does; an add reads row[Bp] where
//     0 <= Bp <= W - 2, which is the entry B points at after the update
//     (up to the flags of the key added, which the test ignores), and
//     reads the row after the update only outside that range.
//   - Steps without a change are skipped: the minimizer loci strictly
//     increase, so the next step at which a cursor's test holds follows
//     from the locus at the cursor (remove: the first step t with
//     locs[rws] <= t0 + t; add: the step with locs[rwe] == re0 + t, never
//     once the locus lies behind); the jaccard changes only at those
//     steps, so the earliest strict improvement is the same.  The loci and
//     the plan's columns are int32 and not negative (the native plan's),
//     so locs - t0 never overflows.
//   - The cursors rws and rwe move forward, by at most one a step.  Each
//     holds a window of 32 loci and keys in registers (lane i: [base + i])
//     read by shuffle, and the next 32 loaded before the cursor reaches
//     them (one coalesced load, double-buffered), so no global load sits
//     on the chain.  Phase A's initial window rws0 ... rws0 + init_cnt is
//     read through such a cursor too.
//   - The window's query keys are sorted once (a bitonic sort over a power
//     of two >= SQ in shared memory), their distinct values compacted by
//     ballots and read into the register row.
// Each interval loops to its own init_cnt and n_steps (capped at INIT_PAD
// and T_PAD); the plain version's padded iterations change no row.

#include <cuda_runtime.h>

#include <cstdint>

#include "row_sort.cuh"

namespace {

constexpr int32_t I32_MIN = static_cast<int32_t>(0x80000000u);
constexpr int WARPS = 4;  // intervals a block

struct RollArgs {
  const int32_t* r_keys;
  const int32_t* r_locs;
  const int32_t* q_keys;
  const int32_t* lut;
  const int32_t* qws;
  const int32_t* qwe;
  const int32_t* t0;
  const int32_t* rws0;
  const int32_t* init_cnt;
  const int32_t* n_steps;
  const int32_t* re0;
  int32_t* best_j;
  int32_t* best_steps;
  uint8_t* ok;
  int B, n_rk, n_rl, n_q, n_lut, nr, SQ, SQP, INIT_PAD, T_PAD, n_shift;
};

// a[min(i, n - 1)]: the plain version's gather (the caller masks the
// clamped lanes); plan indices are never negative, 0 keeps a stray one in
// bounds
__device__ __forceinline__ int32_t gather(const int32_t* a, int i, int n) {
  i = i < n ? i : n - 1;
  return a[i < 0 ? 0 : i];
}

// v[i] for a warp-uniform i in [0, E): a select tree on i's bits
template <int E>
__device__ __forceinline__ int32_t pick(const int32_t (&v)[E], int i) {
  int32_t t[E];
#pragma unroll
  for (int j = 0; j < E; ++j) t[j] = v[j];
#pragma unroll
  for (int w = 1; w < E; w <<= 1) {
    const bool hi = i & w;
#pragma unroll
    for (int j = 0; j < E; j += 2 * w) t[j] = hi ? t[j + w] : t[j];
  }
  return t[0];
}

// row[i], 0 <= i < W, i the same in every lane
template <int E>
__device__ __forceinline__ int32_t row_at(const int32_t (&r)[E], int i) {
  return __shfl_sync(FULL, pick<E>(r, i & (E - 1)), i / E);
}

// row[min(i, W - 1)] under the reference's take_along_axis: [-W, 0) from
// the end, below -W INT32_MIN
template <int E>
__device__ __forceinline__ int32_t take1(const int32_t (&r)[E], int i) {
  constexpr int W = 32 * E;
  i = i < W - 1 ? i : W - 1;
  if (i < 0) i += W;
  const int32_t v = row_at<E>(r, i < 0 ? 0 : i);
  return i < 0 ? I32_MIN : v;
}

// entries of the row whose key is below h (the row is sorted, INF past
// ln): E compares a lane and a warp sum.  (x >> 2) < h is x < 4 h where
// 4 h is an int32, as it is for every real key
template <int E>
__device__ __forceinline__ int lower_pos(const int32_t (&r)[E], int32_t h) {
  int c = 0;
  if (h >= 0 && h < (1 << 29)) {
    const int32_t hh = h << 2;
#pragma unroll
    for (int j = 0; j < E; ++j) c += r[j] < hh;
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) c += (r[j] >> 2) < h;
  }
  return __reduce_add_sync(FULL, c);
}

struct Sketch {
  int ln, Bp, inter;
  bool ovf;
};

// SlidingJaccard._add(h, bit) (ops/sliding.py:67-86); h the same in every
// lane
template <int E>
__device__ __forceinline__ void vadd(int32_t (&r)[E], Sketch& S, int32_t h,
                                     int bit, int lane) {
  constexpr int W = 32 * E;
  // beside the search: the insert's carry and the entry B points at
  const int32_t carry = __shfl_up_sync(FULL, r[E - 1], 1);
  const bool b_inside = S.Bp >= 0 && S.Bp <= W - 2;
  const int32_t ob = row_at<E>(r, b_inside ? S.Bp : 0);
  const int pos = lower_pos<E>(r, h);
  const int32_t cur = row_at<E>(r, pos < W - 1 ? pos : W - 1);
  const int d = pos - E * lane;  // the place, from this lane's first entry
  const bool exists = (cur >> 2) == h && pos < W;
  const int flag_h = exists ? (cur & 3) : 0;
  if (exists && (flag_h & bit)) return;  // already there: no effect
  const bool ins = !exists;
  if (ins && S.ln >= W) {  // full: overflow, the step goes on
    S.ovf = true;
    return;
  }
  if (exists) {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (j == d) r[j] |= bit;
  } else {
    const int32_t v = (h << 2) | bit;
#pragma unroll
    for (int j = E - 1; j >= 0; --j)  // from the top: r[j - 1] still old
      r[j] = j < d ? r[j] : (j == d ? v : (j ? r[j - 1] : carry));
    S.ln += 1;
    if (pos <= S.Bp) S.Bp += 1;  // B keeps pointing at its element
  }
  // the boundary branch, on the row after the insert (sliding.py:81-85):
  // inside the row B points at the entry it pointed at before (a flag
  // update at B changes its flags alone, and its key h fails the test)
  const int32_t bcur = b_inside ? ob : take1<E>(r, S.Bp);
  if (h < (bcur >> 2)) {
    const int new_flag = exists ? (flag_h | bit) : bit;
    if (new_flag == 3) S.inter += 1;
    if (ins) {
      if ((bcur & 3) == 3) S.inter -= 1;
      S.Bp -= 1;
    }
  }
}

// SlidingJaccard._remove(h, bit) (ops/sliding.py:88-109)
template <int E>
__device__ __forceinline__ void vremove(int32_t (&r)[E], Sketch& S,
                                        int32_t h, int bit, int lane) {
  constexpr int W = 32 * E;
  // beside the search: the erase's carry and the two boundary entries the
  // branch may read, both on the row before the erase
  int32_t carry = __shfl_down_sync(FULL, r[0], 1);
  if (lane == 31) carry = INF32;
  const int32_t bcur = take1<E>(r, S.Bp);
  const int32_t b2 = take1<E>(r, S.Bp + 1);
  const int pos = lower_pos<E>(r, h);
  const int32_t cur = row_at<E>(r, pos < W - 1 ? pos : W - 1);
  const int d = pos - E * lane;
  const bool found = (cur >> 2) == h && pos < W;
  const int flag_h = found ? (cur & 3) : 0;
  if (!(found && (flag_h & bit))) return;
  const bool erase = flag_h == bit;
  // the boundary branch first, on the row before the erase
  if (h <= (bcur >> 2)) {
    if (flag_h == 3) S.inter -= 1;
    if (erase) {
      S.Bp += 1;
      if (S.Bp < S.ln && (b2 & 3) == 3) S.inter += 1;
    }
  }
  if (erase) {
#pragma unroll
    for (int j = 0; j < E; ++j)  // from the bottom: r[j + 1] still old
      r[j] = j < d ? r[j] : (j < E - 1 ? r[j + 1] : carry);
    S.ln -= 1;
    if (pos < S.Bp) S.Bp -= 1;
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (j == d) r[j] &= ~bit;
  }
}

// a cursor over the ref's minimizers: lane i holds locus and key
// [base + i] and, loaded ahead, [base + 32 + i]
struct Cursor {
  int c, base;
  int32_t loc_, key_, nloc, nkey;

  __device__ __forceinline__ Cursor(const RollArgs& a, int start, int lane)
      : c(start), base(start) {
    loc_ = gather(a.r_locs, start + lane, a.n_rl);
    key_ = gather(a.r_keys, start + lane, a.n_rk);
    nloc = gather(a.r_locs, start + 32 + lane, a.n_rl);
    nkey = gather(a.r_keys, start + 32 + lane, a.n_rk);
  }
  __device__ __forceinline__ int32_t loc() const {
    return __shfl_sync(FULL, loc_, c - base);
  }
  __device__ __forceinline__ int32_t key() const {
    return __shfl_sync(FULL, key_, c - base);
  }
  // one forward; at the window's end the loaded-ahead one takes its place
  // and the next is loaded
  __device__ __forceinline__ void advance(const RollArgs& a, int lane) {
    if (++c - base == 32) {
      loc_ = nloc;
      key_ = nkey;
      base += 32;
      nloc = gather(a.r_locs, base + 32 + lane, a.n_rl);
      nkey = gather(a.r_keys, base + 32 + lane, a.n_rk);
    }
  }
};

template <int E>
__global__ void __launch_bounds__(WARPS * 32)
    roll_batch_kernel(RollArgs a) {
  constexpr int W = 32 * E;
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= a.B) return;
  int32_t* buf = smem + warp * (W + a.SQP);
  int32_t* scr = buf + W;

  // ---- the window's sorted distinct query keys, flags 1, B = s - 1 ----
  const int qws = a.qws[b], qwe = a.qwe[b];
  for (int j = lane; j < a.SQP; j += 32)
    scr[j] = (j < a.SQ && qws + j < qwe) ? gather(a.q_keys, qws + j, a.n_q)
                                         : INF32;
  for (int j = lane; j < W; j += 32) buf[j] = INF32;
  __syncwarp();
  group_bitonic<32>(scr, a.SQP, lane);
  int s = 0;
  for (int base = 0; base < a.SQ; base += 32) {
    const int j = base + lane;
    const int32_t v = j < a.SQ ? scr[j] : INF32;
    const bool keep = v != INF32 && (j == 0 || scr[j - 1] != v);
    const unsigned m = __ballot_sync(FULL, keep);
    if (keep) buf[s + __popc(m & ((1u << lane) - 1))] = (v << 2) | 1;
    s += __popc(m);
  }
  __syncwarp();
  int32_t r[E];
#pragma unroll
  for (int j = 0; j < E; ++j) r[j] = buf[E * lane + j];
  const int32_t limit = a.lut[s < a.n_lut - 1 ? s : a.n_lut - 1];
  Sketch S{s, s - 1, 0, (qwe - qws) > a.SQ};

  // ---- phase A: add_to_reference over the initial window ----
  const int rws0 = a.rws0[b], init_cnt = a.init_cnt[b];
  const int n_init = init_cnt < a.INIT_PAD ? init_cnt : a.INIT_PAD;
  {
    Cursor I(a, rws0, lane);
    for (int i = 0; i < n_init; ++i) {
      const int32_t h = I.key();
      if ((h >> a.n_shift) != 2) vadd<E>(r, S, h, 2, lane);
      I.advance(a, lane);
    }
  }

  // ---- phase B: the roll (search.cc:289-315), from change to change ----
  auto jaccard = [&](int inter) {
    return inter >= limit ? inter : inter - limit;
  };
  int32_t best_j = jaccard(S.inter), best_steps = 0;
  const int t0 = a.t0[b], re0 = a.re0[b];
  const int n_steps = a.n_steps[b];
  const int n_roll = n_steps < a.T_PAD ? n_steps : a.T_PAD;
  Cursor R(a, rws0, lane), A(a, rws0 + init_cnt, lane);
  constexpr int NEVER = 0x7fffffff;
  for (int t = 0;; ++t) {
    const int32_t loc_r = R.loc(), h_r = R.key();
    const int32_t loc_a = A.loc(), h_a = A.key();
    // the first step from t at which each test holds: remove while
    // locs[rws] < rs + 1 (rs = t0 + t), add where locs[rwe] == re0 + t
    const int ur = loc_r - t0, ua = loc_a - re0;
    const int tr = R.c < a.nr ? (ur > t ? ur : t) : NEVER;
    const int ta = A.c < a.nr && ua >= t ? ua : NEVER;
    t = tr < ta ? tr : ta;
    if (t >= n_roll) break;
    if (tr == t) {
      if ((h_r >> a.n_shift) != 2) vremove<E>(r, S, h_r, 2, lane);
      R.advance(a, lane);
    }
    if (ta == t) {
      if ((h_a >> a.n_shift) != 2) vadd<E>(r, S, h_a, 2, lane);
      A.advance(a, lane);
    }
    // strict improvement, earliest wins
    const int32_t j = jaccard(S.inter);
    if (j > best_j) {
      best_j = j;
      best_steps = t + 1;
    }
  }
  if (lane == 0) {
    a.best_j[b] = best_j;
    a.best_steps[b] = best_steps;
    a.ok[b] = !(S.ovf || init_cnt > a.INIT_PAD || n_steps > a.T_PAD);
  }
}

template <int E>
int launch(const RollArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * WARPS * (size_t)(32 * E + a.SQP);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roll_batch_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  roll_batch_kernel<E><<<(a.B + WARPS - 1) / WARPS, WARPS * 32, smem,
                         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B interval rolls.  Plan columns qws, qwe, t0, rws0, init_cnt, n_steps,
// re0: (B,) int32; r_keys (n_rk,), r_locs (n_rl,), q_keys (n_q,), lut
// (n_lut,): int32; nr: the ref's minimizer count.  Writes best_j,
// best_steps (B,) int32 and ok (B,) bool.  W row entries, 64 or 512 (the
// register rows built; any other W is refused), SQ <= W; INIT_PAD / T_PAD
// the loop caps, n_shift = 2k.  Launches on ``stream`` without
// synchronising; returns a CUDA error code.
int sedef_roll_batch(const void* r_keys, const void* r_locs,
                     const void* q_keys, const void* lut, const void* qws,
                     const void* qwe, const void* t0, const void* rws0,
                     const void* init_cnt, const void* n_steps,
                     const void* re0, void* best_j, void* best_steps,
                     void* ok, int B, int n_rk, int n_rl, int n_q, int n_lut,
                     int nr, int W, int SQ, int INIT_PAD, int T_PAD,
                     int n_shift, void* stream) {
  if ((W != 64 && W != 512) || SQ < 1 || SQ > W || n_rk < 1 || n_rl < 1 ||
      n_q < 1 || n_lut < 1 || n_shift < 0 || n_shift > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  int SQP = 2;
  while (SQP < SQ) SQP <<= 1;
  const RollArgs a = {static_cast<const int32_t*>(r_keys),
                      static_cast<const int32_t*>(r_locs),
                      static_cast<const int32_t*>(q_keys),
                      static_cast<const int32_t*>(lut),
                      static_cast<const int32_t*>(qws),
                      static_cast<const int32_t*>(qwe),
                      static_cast<const int32_t*>(t0),
                      static_cast<const int32_t*>(rws0),
                      static_cast<const int32_t*>(init_cnt),
                      static_cast<const int32_t*>(n_steps),
                      static_cast<const int32_t*>(re0),
                      static_cast<int32_t*>(best_j),
                      static_cast<int32_t*>(best_steps),
                      static_cast<uint8_t*>(ok),
                      B, n_rk, n_rl, n_q, n_lut, nr, SQ, SQP, INIT_PAD,
                      T_PAD, n_shift};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return W == 512 ? launch<16>(a, s) : launch<2>(a, s);
}

}  // extern "C"
