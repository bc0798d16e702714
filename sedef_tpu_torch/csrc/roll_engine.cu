// The stage-1 roll engine: one batch of interval rolls, every step of every
// interval inside one launch.
//
// Replaces _roll_batch (sedef_tpu/ops/roll_engine.py:143), a jit program
// whose two loops are lax.fori_loops; its plain PyTorch version is
// _roll_batch_torch in ops/roll_engine.py, which this kernel follows
// branch for branch.  Each interval replays the op stream of the
// reference's roll (search.cc:289-315) on its own sliding sketch: one
// sorted row of W int32 entries ``key << 2 | flags`` (query = 1, ref = 2),
// INF-padded past its ``ln`` live entries, with the boundary index Bp,
// the path-dependent intersection counter and the four quirk branches of
// SlidingJaccard (ops/sliding.py): the boundary branch after the physical
// insert and before the physical erase, a key equal to the boundary
// element not counted (sliding.cc:86), HAS_N ref keys skipped, and an
// insert into a full row (ln >= W) that sets ``ovf`` and keeps the step.
// An empty query window starts with Bp = -1; a negative Bp indexes the row
// from its end, as the reference's take_along_axis does, and one below -W
// reads INT32_MIN.
//
// What bounds it on the H100: nothing the card can run wide.  A step
// depends on the one before, so an interval is a chain of some
// 2 * n_steps + init_cnt sketch updates, each a search of the sorted row
// and a shift of its tail; a batch of 1,024 intervals gives 1,024 such
// chains, eight warps an SM.  The bytes (the plan columns and the
// minimizer arrays, read once) and the operations (a W-wide pass an
// update) are far below what the chains' latency costs.
//
// What the design does about it: a warp per interval, its row in shared
// memory (2 KB at W 512), its scalars (ln, Bp, intersection, overflow,
// the window pointers, the best jaccard) in registers, the same in every
// lane.  The search for a key's place is a ballot over 32 entries at a
// time that stops at the first chunk holding a larger key, and only
// covers the live entries, so a search costs ceil(pos / 32) shared loads;
// an insert or an erase moves only [pos, ln), 32 entries a step, with a
// __syncwarp between the loads and the stores of a step.  Each interval
// loops to its own init_cnt and n_steps (capped at INIT_PAD and T_PAD):
// the plain version's padded iterations change no row.  The window's
// query keys are sorted once (a bitonic sort over a power of two >= SQ)
// and their distinct values compacted into the row by ballots.

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
  int B, n_rk, n_rl, n_q, n_lut, nr, W, SQ, SQP, INIT_PAD, T_PAD, n_shift;
};

// a[min(i, n - 1)]: the plain version's gather (the caller masks the
// clamped lanes); plan indices are never negative, 0 keeps a stray one in
// bounds
__device__ __forceinline__ int32_t gather(const int32_t* a, int i, int n) {
  i = i < n ? i : n - 1;
  return a[i < 0 ? 0 : i];
}

// row[min(i, W - 1)] under the reference's take_along_axis: [-W, 0) from
// the end, below -W INT32_MIN
__device__ __forceinline__ int32_t take1(const int32_t* row, int i, int W) {
  i = i < W - 1 ? i : W - 1;
  if (i < 0) i += W;
  return i < 0 ? I32_MIN : row[i];
}

struct Sketch {
  int ln, Bp, inter;
  bool ovf;
};

// entries of the row whose key is below h: the row is sorted and its
// entries past ln are INF (INF >> 2 exceeds every packed key for k <= 13),
// so the count stops at the first chunk that holds a key >= h
__device__ __forceinline__ int lower_pos(const int32_t* row, int ln,
                                         int32_t h, int lane) {
  int pos = 0;
  for (int base = 0; base < ln; base += 32) {
    const int j = base + lane;
    const unsigned m = __ballot_sync(FULL, j < ln && (row[j] >> 2) < h);
    pos += __popc(m);
    if (m != FULL) break;
  }
  return pos;
}

// SlidingJaccard._add(h, bit) (ops/sliding.py:67-86); doit is the same in
// every lane
__device__ void vadd(int32_t* row, Sketch& S, int32_t h, int bit, bool doit,
                     int lane, int W) {
  if (!doit) return;
  const int pos = lower_pos(row, S.ln, h, lane);
  const int32_t cur = row[pos < W - 1 ? pos : W - 1];
  const bool exists = (cur >> 2) == h && pos < W;
  const int flag_h = exists ? (cur & 3) : 0;
  if (exists && (flag_h & bit)) return;  // already there: no effect
  const bool ins = !exists;
  if (ins && S.ln >= W) {  // full: overflow, the step goes on
    S.ovf = true;
    return;
  }
  if (exists) {
    if (lane == 0) row[pos] = cur | bit;
  } else {
    // shift [pos, ln) right by one, from the top, 32 entries a step
    for (int top = S.ln; top > pos; top -= 32) {
      const int j = top - 32 + lane;
      const bool v = j >= pos;
      const int32_t x = v ? row[j] : 0;
      __syncwarp();
      if (v) row[j + 1] = x;
      __syncwarp();
    }
    if (lane == 0) row[pos] = (h << 2) | bit;
    S.ln += 1;
    if (pos <= S.Bp) S.Bp += 1;  // B keeps pointing at its element
  }
  __syncwarp();
  // the boundary branch, on the row after the insert (sliding.py:81-85)
  const int32_t bcur = take1(row, S.Bp, W);
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
__device__ void vremove(int32_t* row, Sketch& S, int32_t h, int bit,
                        bool doit, int lane, int W) {
  if (!doit) return;
  const int pos = lower_pos(row, S.ln, h, lane);
  const int32_t cur = row[pos < W - 1 ? pos : W - 1];
  const bool found = (cur >> 2) == h && pos < W;
  const int flag_h = found ? (cur & 3) : 0;
  if (!(found && (flag_h & bit))) return;
  const bool erase = flag_h == bit;
  // the boundary branch first, on the row before the erase
  const int32_t bcur = take1(row, S.Bp, W);
  if (h <= (bcur >> 2)) {
    if (flag_h == 3) S.inter -= 1;
    if (erase) {
      S.Bp += 1;
      const int32_t b2 = take1(row, S.Bp, W);
      if (S.Bp < S.ln && (b2 & 3) == 3) S.inter += 1;
    }
  }
  if (erase) {
    // shift [pos + 1, ln) left by one, from the bottom; row[ln - 1] = INF
    for (int base = pos; base < S.ln; base += 32) {
      const int j = base + lane;
      const int32_t x = j + 1 < S.ln ? row[j + 1] : INF32;
      __syncwarp();
      if (j < S.ln) row[j] = x;
      __syncwarp();
    }
    S.ln -= 1;
    if (pos < S.Bp) S.Bp -= 1;
  } else if (lane == 0) {
    row[pos] = cur & ~bit;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(WARPS * 32)
    roll_batch_kernel(RollArgs a) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= a.B) return;
  const int W = a.W;
  int32_t* row = smem + warp * (W + a.SQP);
  int32_t* scr = row + W;

  // ---- the window's sorted distinct query keys, flags 1, B = s - 1 ----
  const int qws = a.qws[b], qwe = a.qwe[b];
  for (int j = lane; j < a.SQP; j += 32)
    scr[j] = (j < a.SQ && qws + j < qwe) ? gather(a.q_keys, qws + j, a.n_q)
                                         : INF32;
  for (int j = lane; j < W; j += 32) row[j] = INF32;
  __syncwarp();
  group_bitonic<32>(scr, a.SQP, lane);
  int s = 0;
  for (int base = 0; base < a.SQ; base += 32) {
    const int j = base + lane;
    const int32_t v = j < a.SQ ? scr[j] : INF32;
    const bool keep = v != INF32 && (j == 0 || scr[j - 1] != v);
    const unsigned m = __ballot_sync(FULL, keep);
    if (keep) row[s + __popc(m & ((1u << lane) - 1))] = (v << 2) | 1;
    s += __popc(m);
  }
  __syncwarp();
  const int32_t limit = a.lut[s < a.n_lut - 1 ? s : a.n_lut - 1];
  Sketch S{s, s - 1, 0, (qwe - qws) > a.SQ};

  // ---- phase A: add_to_reference over the initial window ----
  const int rws0 = a.rws0[b], init_cnt = a.init_cnt[b];
  const int n_init = init_cnt < a.INIT_PAD ? init_cnt : a.INIT_PAD;
  for (int i = 0; i < n_init; ++i) {
    const int32_t h = gather(a.r_keys, rws0 + i, a.n_rk);
    vadd(row, S, h, 2, (h >> a.n_shift) != 2, lane, W);
  }

  // ---- phase B: the roll (search.cc:289-315) ----
  auto jaccard = [&](int inter) {
    return inter >= limit ? inter : inter - limit;
  };
  int32_t best_j = jaccard(S.inter), best_steps = 0;
  int rws = rws0, rwe = rws0 + init_cnt, rs = a.t0[b], re = a.re0[b];
  const int n_steps = a.n_steps[b];
  const int n_roll = n_steps < a.T_PAD ? n_steps : a.T_PAD;
  for (int t = 0; t < n_roll; ++t) {
    // conditional remove: locs[rws] < rs + 1
    const int32_t loc_r = gather(a.r_locs, rws, a.n_rl);
    const int32_t h_r = gather(a.r_keys, rws, a.n_rk);
    const bool can_r = rws < a.nr && loc_r < rs + 1;
    vremove(row, S, h_r, 2, can_r && (h_r >> a.n_shift) != 2, lane, W);
    rws += can_r;
    // conditional add: locs[rwe] == re
    const int32_t loc_a = gather(a.r_locs, rwe, a.n_rl);
    const int32_t h_a = gather(a.r_keys, rwe, a.n_rk);
    const bool can_a = rwe < a.nr && loc_a == re;
    vadd(row, S, h_a, 2, can_a && (h_a >> a.n_shift) != 2, lane, W);
    rwe += can_a;
    // strict improvement, earliest wins
    const int32_t j = jaccard(S.inter);
    if (j > best_j) {
      best_j = j;
      best_steps = t + 1;
    }
    rs += 1;
    re += 1;
  }
  if (lane == 0) {
    a.best_j[b] = best_j;
    a.best_steps[b] = best_steps;
    a.ok[b] = !(S.ovf || init_cnt > a.INIT_PAD || n_steps > a.T_PAD);
  }
}

}  // namespace

extern "C" {

// One batch of B interval rolls.  Plan columns qws, qwe, t0, rws0,
// init_cnt, n_steps, re0: (B,) int32; r_keys (n_rk,), r_locs (n_rl,),
// q_keys (n_q,), lut (n_lut,): int32; nr: the ref's minimizer count.
// Writes best_j, best_steps (B,) int32 and ok (B,) bool.  W >= SQ row
// entries, INIT_PAD / T_PAD the loop caps, n_shift = 2k.  Launches on
// ``stream`` without synchronising; returns a CUDA error code.
int sedef_roll_batch(const void* r_keys, const void* r_locs,
                     const void* q_keys, const void* lut, const void* qws,
                     const void* qwe, const void* t0, const void* rws0,
                     const void* init_cnt, const void* n_steps,
                     const void* re0, void* best_j, void* best_steps,
                     void* ok, int B, int n_rk, int n_rl, int n_q, int n_lut,
                     int nr, int W, int SQ, int INIT_PAD, int T_PAD,
                     int n_shift, void* stream) {
  if (W < 1 || SQ < 1 || SQ > W || n_rk < 1 || n_rl < 1 || n_q < 1 ||
      n_lut < 1 || n_shift < 0 || n_shift > 30)
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
                      B, n_rk, n_rl, n_q, n_lut, nr, W, SQ, SQP, INIT_PAD,
                      T_PAD, n_shift};
  const size_t smem = sizeof(int32_t) * WARPS * (size_t)(W + SQP);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roll_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  roll_batch_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
