// The roll prefilter's verdicts, an interval a block: for each planned
// interval of a chromosome pair, its query sketch, phase A's span bound and
// phase B's composition windows, all built on the card from the plan's five
// columns, and one record out: pruned in phase A, pruned in phase B or not
// pruned, and the interval's composition rows.
//
// Replaces, on a card, RollPrefilter's whole flow in the reference
// (sedef_tpu/ops/prefilter.py:255-381): its three jit programs
// (_window_sketches :73, _span_intersections :92, _composition_ideals
// :118) and the host work between them (phase A's span ends and phase B's
// event rows and window bounds by np.searchsorted, a pull of every row's
// ideal and np.maximum.at).  Its plain PyTorch version is
// _interval_verdicts_torch in ops/prefilter.py.  Per interval, with
// rws0 = the first locus >= t0 (native find_minimizers(t0), the plan's):
//   sketch    warp_sketch over q_keys[qws, qwe) (SQ keys at most);
//             eligible = qwe - qws <= SQ and s > 0, limit = lut[min(s, .)]
//   phase A   span_end = the first locus >= t0 + n_steps + L; span_i = the
//             distinct sketch keys among the span's [rws0, span_end) keys
//             (HAS_N dropped), INF32 past SA; pruned when span_i < limit
//   phase B   (eligible, not pruned in A) the windows starting at t0 and
//             at clip(loc + 1, t0, t0 + n_steps), clip(loc - L + 1, ...)
//             for each span locus, their [a, b) the loci in [rs, rs + L);
//             a window's ideal is rank_count's, INF32 past RW; pruned when
//             every window's ideal is below limit; rows = 2 span_n + 1
//
// What bounds it on the H100: the data the verdicts need, each span's keys
// and loci and each query window read once and the sorts of the windows'
// keys (n log2 n compare-exchanges each, ~80 keys a window), with a
// search of the sketch for each distinct key.  The per-row flow moved the
// windows' bounds through the host and every row's ideal back.
//
// What the design does about it: a block of eight warps an interval.  Warp
// 0 builds the sketch in shared memory while warp 1 finds span_end by a
// 32-way search of the loci.  The span's loci and keys are staged in
// shared memory a tile of ``tile`` loci at a time with RW + 1 loci of halo
// on each side, so that an unclipped event's window bounds are two warp
// searches of the staged loci and its keys shared-memory reads; a bound
// that falls outside the tile (a clipped event) is searched over all the
// loci, which gives the same index.  Phase A marks the sketch slots its
// keys hit (a shared flag a slot) and counts them.  Phase B gives the rows
// of a tile to the warps in turn; a warp sorts its window in its own
// shared row and counts its ideal, and the first window whose ideal
// reaches limit settles the interval (not pruned): the block stops there.
// Load imbalance between intervals is left to the block scheduler (a span
// of 2,000 loci is 4,001 rows, one of 40 is 81).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "window_rows.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROW_PAD = 256;  // a window's row: RW <= 256

struct IntervalArgs {
  const int32_t* q_keys;
  const int32_t* r_keys;
  const int32_t* r_locs;  // ascending
  const int32_t* lut;
  const int32_t* plan;    // (5, n): qws, qwe, t0, rws0, n_steps
  int32_t* rec;           // (n, 2): verdict (0, 1: A, 2: B), rows
  int n, n_q, n_rk, n_lut, SQ, RW, SA, L, n_shift, tile;
};

__device__ __forceinline__ long long clip(long long x, long long lo,
                                          long long hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__global__ void __launch_bounds__(THREADS)
    prefilter_intervals_kernel(IntervalArgs p) {
  extern __shared__ int32_t smem[];
  __shared__ int red[32];
  __shared__ int sh_s, sh_limit, sh_span_end, sh_alive;
  __shared__ long long sh_left, sh_right;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int iv = blockIdx.x;
  const int halo = p.RW + 1;
  const int stage_n = p.tile + 2 * halo;
  int32_t* q = smem;                    // SQ: the sketch
  int32_t* flags = q + p.SQ;            // SQ: phase A's hit slots
  int32_t* st_locs = flags + p.SQ;      // stage_n: a tile's loci
  int32_t* st_keys = st_locs + stage_n;  // stage_n: their keys, HAS_N INF
  int32_t* rows = st_keys + stage_n;    // WARPS x ROW_PAD (the sketch's
                                        // scratch before phase B)

  const int qws = p.plan[iv], qwe = p.plan[p.n + iv];
  const long long t0 = p.plan[2 * p.n + iv];
  // a plan's rws0 is in [0, n_rk]; held there so that no index leaves
  // the stage or the keys on another input
  const int rws0 = min(max(p.plan[3 * p.n + iv], 0), p.n_rk);
  const long long t1 = t0 + p.plan[4 * p.n + iv];  // t0 + n_steps
  int32_t* rec = p.rec + 2 * static_cast<long>(iv);
  if (static_cast<long long>(qwe) - qws > p.SQ) {  // overflow: not eligible
    if (tid == 0) rec[0] = rec[1] = 0;
    return;
  }

  // ---- the sketch (warp 0), span_end (warp 1), the flags (the rest) ----
  if (warp == 0) {
    const int s = warp_sketch(p.q_keys, p.n_q, qws, qwe, p.SQ, rows, q,
                              lane);
    if (lane == 0) {
      sh_s = s;
      sh_limit = p.lut[s < p.n_lut - 1 ? s : p.n_lut - 1];
    }
  } else if (warp == 1) {
    const int e = warp_lower_bound(p.r_locs, 0, p.n_rk, t1 + p.L, lane);
    if (lane == 0) sh_span_end = e;
  } else {
    for (int j = tid - 64; j < p.SQ; j += THREADS - 64) flags[j] = 0;
    if (tid == 64) sh_alive = 0;
  }
  __syncthreads();
  const int s = sh_s, limit = sh_limit, span_end = sh_span_end;
  if (s == 0) {  // an empty sketch: not eligible
    if (tid == 0) rec[0] = rec[1] = 0;
    return;
  }
  const int span_n = span_end - rws0 > 0 ? span_end - rws0 : 0;
  const int rows_b = 2 * span_n + 1;

  // the tile of loci [lo, hi) is staged with its halo: loci [s0, s1) of
  // the span, and the loci on either side as the bracket of a search
  auto stage = [&](int lo, int hi) {
    int s0 = lo - halo > rws0 ? lo - halo : rws0;
    int s1 = hi + halo < span_end ? hi + halo : span_end;
    s0 = s0 < 0 ? 0 : (s0 > p.n_rk ? p.n_rk : s0);
    s1 = s1 < s0 ? s0 : (s1 > p.n_rk ? p.n_rk : s1);
    for (int j = tid; j < s1 - s0; j += THREADS) {
      st_locs[j] = p.r_locs[s0 + j];
      st_keys[j] = sketch_key(p.r_keys[s0 + j], p.n_shift);
    }
    if (tid == 0) {
      sh_left = s0 == 0 ? LLONG_MIN : p.r_locs[s0 - 1];
      sh_right = s1 == p.n_rk ? LLONG_MAX : p.r_locs[s1];
    }
    return make_int2(s0, s1);
  };
  int2 range = stage(rws0, rws0 + (span_n < p.tile ? span_n : p.tile));
  __syncthreads();

  // ---- phase A: the span's distinct keys in the sketch ----
  {
    const int s0 = range.x, s1 = range.y;
    int span_i = INF32;
    if (span_n <= p.SA) {
      const bool staged = rws0 >= s0 && span_end <= s1;
      for (int j = tid; j < span_n; j += THREADS) {
        int32_t k;
        if (staged) {
          k = st_keys[rws0 - s0 + j];
        } else {
          const int i = rws0 + j < p.n_rk ? rws0 + j : p.n_rk - 1;
          k = sketch_key(p.r_keys[i < 0 ? 0 : i], p.n_shift);
        }
        if (k == INF32) continue;
        int lo = 0, hi = p.SQ;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (q[mid] < k)
            lo = mid + 1;
          else
            hi = mid;
        }
        if (lo < p.SQ && q[lo] == k) atomicOr(&flags[lo], 1);
      }
      __syncthreads();
      int hits = 0;
      for (int j = tid; j < p.SQ; j += THREADS) hits += flags[j];
      span_i = group_sum<THREADS>(hits, tid, red);
    }
    if (span_i < limit) {  // pruned in phase A (INF32 never is)
      if (tid == 0) {
        rec[0] = 1;
        rec[1] = 0;
      }
      return;
    }
  }

  // ---- phase B: every composition window, a warp a row ----
  int32_t* row = rows + warp * ROW_PAD;
  for (int lo = rws0, first = 1; first || lo < rws0 + span_n;
       lo += p.tile, first = 0) {
    const int hi = rws0 + span_n - lo < p.tile ? rws0 + span_n : lo + p.tile;
    if (!first) {
      range = stage(lo, hi);
      __syncthreads();
    }
    const int s0 = range.x, m = range.y - range.x;
    const long long left = sh_left, right = sh_right;
    // the first locus >= x: in the stage when the bracket holds it, else
    // over all the loci (the same index)
    auto find = [&](long long x) {
      if (x > left && x <= right)
        return s0 + warp_lower_bound(st_locs, 0, m, x, lane);
      return warp_lower_bound(p.r_locs, 0, p.n_rk, x, lane);
    };
    const int cnt = hi - lo;
    const int nt = 2 * cnt + first;  // the t0 window in the first tile
    for (int r = warp; r < nt; r += WARPS) {
      int stop = 0;
      if (lane == 0) stop = atomicAdd(&sh_alive, 0);
      if (__shfl_sync(FULL, stop, 0)) break;
      long long rs = t0;
      if (r < 2 * cnt) {
        const long long loc = st_locs[lo + (r < cnt ? r : r - cnt) - s0];
        rs = r < cnt ? clip(loc + 1, t0, t1) : clip(loc - p.L + 1, t0, t1);
      }
      const int a = find(rs), b = find(rs + p.L);
      int ideal = INF32;
      if (b - a <= p.RW) {
        const int n = b - a > 0 ? b - a : 0;
        int n2 = 2;
        while (n2 < n) n2 <<= 1;
        const bool staged = a >= s0 && b <= s0 + m;
        __syncwarp();
        for (int j = lane; j < n2; j += 32) {
          int32_t v = INF32;
          if (j < n)
            v = staged ? st_keys[a - s0 + j]
                       : sketch_key(p.r_keys[a + j], p.n_shift);
          row[j] = v;
        }
        __syncwarp();
        group_bitonic<32>(row, n2, lane);
        ideal = rank_count<ROW_PAD, 32>(row, n2, q, p.SQ, s, lane, red);
      }
      if (ideal >= limit) {  // this window may pass: not pruned
        if (lane == 0) atomicOr(&sh_alive, 1);
        break;
      }
    }
    __syncthreads();
    if (atomicAdd(&sh_alive, 0)) break;
  }
  if (tid == 0) {
    rec[0] = atomicAdd(&sh_alive, 0) ? 0 : 2;
    rec[1] = rows_b;
  }
}

}  // namespace

extern "C" {

// n intervals' prefilter verdicts.  q_keys (n_q,), r_keys and r_locs
// (n_rk,) int32, r_locs ascending; lut (n_lut,) int32 the relaxed limits
// by sketch size; plan (5, n) int32 the columns qws, qwe, t0, rws0,
// n_steps (0 <= rws0 <= n_rk, the first locus >= t0).  Writes rec (n, 2)
// int32: 1 where phase A prunes the interval, 2 where phase B does, else
// 0; then the interval's composition rows (0 unless phase B ran).  SQ <=
// 1,024, RW <= 256, tile >= 1 loci staged at a time.  Launches on
// ``stream`` without synchronising; returns a CUDA error code.
int sedef_prefilter_intervals(const void* q_keys, const void* r_keys,
                              const void* r_locs, const void* lut,
                              const void* plan, void* rec, int n, int n_q,
                              int n_rk, int n_lut, int SQ, int RW, int SA,
                              int L, int n_shift, int tile, void* stream) {
  if (n_q < 1 || n_rk < 1 || n_lut < 1 || SQ < 1 || SQ > 1024 || RW < 1 ||
      RW > ROW_PAD || SA < 0 || L < 0 || n_shift < 0 || n_shift > 30 ||
      tile < 1 || tile > 4096 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int SQP = 2;
  while (SQP < SQ) SQP <<= 1;
  const IntervalArgs a = {static_cast<const int32_t*>(q_keys),
                          static_cast<const int32_t*>(r_keys),
                          static_cast<const int32_t*>(r_locs),
                          static_cast<const int32_t*>(lut),
                          static_cast<const int32_t*>(plan),
                          static_cast<int32_t*>(rec),
                          n, n_q, n_rk, n_lut, SQ, RW, SA, L, n_shift, tile};
  // the sketch's scratch (SQP) lives in the rows' space
  const int rows = WARPS * ROW_PAD > SQP ? WARPS * ROW_PAD : SQP;
  const size_t smem = sizeof(int32_t) *
      (2 * static_cast<size_t>(SQ) + 2 * (tile + 2 * (RW + 1)) + rows);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefilter_intervals_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  prefilter_intervals_kernel<<<static_cast<unsigned>(n), THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
