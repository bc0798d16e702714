// Tracebacks of the anti-diagonal DP into 2-bit packed ops: the whole
// direction matrix at once, or one tile of the tiled route at a time.
//
// Replaces, by entry point (TPU kernels in sedef_tpu/ops/wavefront.py):
//   sedef_walk  ws == null      backtrack_pallas_batch and the 2-bit
//                               packing in wavefront_cigar_device
//               ws, K == 1      _backtrack_tile
//               ws, K > 1       _backtrack_tile_pipe
// All three are one kernel: a whole matrix is a tile that starts at stream
// row 0 and holds every row, walked from the problem's corner instead of a
// saved walker.  It reads direction rows written by the fills and emits,
// per problem, one 2-bit code per anti-diagonal row: 0 = M, 1 = I (consumes
// target), 2 = D (consumes query), 3 = row not consumed.  Row r lives at
// byte r / 4, bits 2 * (r % 4); cigar_from_packed_ops decodes it, adding
// the trailing I/D residuals of a walker that leaves on an edge.  Problem
// k of a K-problem stream reads stream rows [k * S_q, k * S_q + n_diag)
// (the direct layout is K = 1).
//
// The walker is ksw2's state machine (ksw2.h:117-151) with a full band:
// it starts at (i, j) = (tl - 1, ql - 1) in state 0, consumes row
// r = i + j, and applies the forced states outside [st0, en0] exactly like
// backtrack_np / the TPU kernels' row_one.  A tile call resumes a walker
// from its saved (i, j, state) and stops below the tile's first row; tiles
// are walked from the last to the first.  A call owns the bytes of its
// rows, [lo / 4, ceil(hi / 4)): tile boundaries and stream offsets are
// multiples of 4 rows, so every byte belongs to one tile.
//
// What bounds it on the H100: the walk is a chain of dependent one-byte
// reads, one per consumed row, scattered over a slab of up to ~7.5 GB (a
// tile of the tiled route is larger than L2 and has just been written), so
// with one read per step it pays one memory latency per consumed row; it
// reads ~ql + tl bytes of the (ql + tl) * tl it could, and a launch has as
// few as one walker.  (The TPU kernels swept every row for 8 lockstep
// walkers.)
//
// What the design does about it: a warp per walker, on a window the whole
// warp fetches at once.  A walker at (i, j), row r = i + j, lowers i by at
// most one per step and r by at least one, so in its next R rows it can
// only touch lanes (i - R, i] of rows (r - R, r].  The warp's lanes copy
// that patch (one lane a row, in 16-byte segments with cp.async; 4-byte or
// single-byte copies where the row stride or the base is not aligned) into
// shared memory; lane 0 then runs the state machine on shared memory until
// the walker leaves the patch or the tile.  Before lane 0 starts, the warp
// starts the copy of the patch below as well, into a second buffer: rows
// (r - 2 R, r - R], from lane i - (pw - 16) + 1 on.  With pw = 2 R + 16
// bytes a row that patch covers every lane the walker can reach, so the
// guess cannot fail; a narrower patch may not hold the walker when it
// arrives (after a long run of I), and is then fetched again at the
// walker's own place: the result never depends on the guess.  One memory
// latency is paid per patch, R / 2 to R consumed rows, and it overlaps the
// walk of the patch before.  What is left is lane 0's chain of dependent
// instructions a step, so its loop is kept short: a walker that is inside
// its problem (i < tl, j < ql: every walker that started at the corner)
// can never be forced, since i and j only fall, and takes a loop without
// the band tests whose byte index moves with the step.  The 0xFF bytes of
// rows the walker never reaches are written by the whole warp first; lane 0
// assembles the byte of the current 4 rows in a register and stores it
// once.  The walker of one
// thread per problem, which pays a latency per row, stays as the yardstick
// (R = 0; tools/kbench.py times both).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// One step of the walker at (i, j) in ``state`` on the direction byte
// ``tmp`` of row r, lane i (0 where the state is forced); returns the op.
__device__ __forceinline__ int step(int tmp, int force, int& i, int& j,
                                    int& state) {
  int s1 = (state != 0 && ((tmp >> (state + 2)) & 1)) ? state : (tmp & 7);
  if (force >= 0) s1 = force;
  const int op = s1 == 0 ? 0 : (s1 == 2 ? 2 : 1);
  state = s1;
  if (op != 2) --i;  // M and I consume the target
  if (op != 1) --j;  // M and D consume the query
  return op;
}

// The forced state of a walker at lane i of row r: 2 left of the band, 1
// right of it, -1 inside.
__device__ __forceinline__ int forced(int r, int i, int qlb, int tlb) {
  const int st0 = max(0, r - qlb + 1);
  const int en0 = min(r, tlb - 1);
  return i < st0 ? 2 : (i > en0 ? 1 : -1);
}

__device__ __forceinline__ unsigned put_op(unsigned acc, int r, int op) {
  const int sh = 2 * (r & 3);
  return (acc & ~(3u << sh)) | ((unsigned)op << sh);
}

__device__ bool lengths_ok(int qlb, int tlb, int S_q, int S_t) {
  // lengths outside the class: nothing is read (the wrapper's caller
  // validates lengths on the host; this only keeps reads in the slab)
  return qlb >= 1 && qlb <= S_q && tlb >= 1 && tlb <= S_t;
}

// What one walker of a launch works on: local rows [lo, hi) of its problem,
// ``plo`` pointing at local row lo (rows S_t bytes apart), its packed bytes
// ``ob`` and its true lengths.  Returns false when the problem has no row
// in the tile.
struct Job {
  const uint8_t* plo;
  uint8_t* ob;
  int lo, hi, qlb, tlb;
};

__device__ __forceinline__ bool job_of(int b, const uint8_t* p,
                                       const int32_t* ql, const int32_t* tl,
                                       uint8_t* out, int K, int S_q, int S_t,
                                       int n_bytes, int r0, int tile,
                                       Job& job) {
  const int s = b / K;
  const int off = (b % K) * S_q;  // the problem's first stream row
  const int n_diag = S_q + S_t - 1;
  job.lo = max(0, r0 - off);
  job.hi = min(n_diag, r0 + tile - off);
  if (job.lo >= job.hi) return false;
  job.ob = out + (size_t)b * n_bytes;
  job.qlb = ql[b];
  job.tlb = tl[b];
  job.plo = p + ((size_t)s * tile + (job.lo + off - r0)) * S_t;
  return true;
}

// ---------------------------------------------------------------------------
// The yardstick: one thread per walker, one global read per consumed row
// ---------------------------------------------------------------------------

__global__ void walk_thread_kernel(const uint8_t* __restrict__ p,
                                   const int32_t* __restrict__ ql,
                                   const int32_t* __restrict__ tl,
                                   int32_t* __restrict__ ws,
                                   uint8_t* __restrict__ out, int B, int K,
                                   int S_q, int S_t, int n_bytes, int r0,
                                   int tile) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Job jb;
  if (!job_of(b, p, ql, tl, out, K, S_q, S_t, n_bytes, r0, tile, jb)) return;
  const int b_lo = jb.lo >> 2;
  int cb = ((jb.hi + 3) >> 2) - 1;  // byte being assembled
  if (!lengths_ok(jb.qlb, jb.tlb, S_q, S_t)) {
    for (int k = b_lo; k <= cb; ++k) jb.ob[k] = 0xFF;
    return;
  }
  int i = jb.tlb - 1, j = jb.qlb - 1, state = 0;
  if (ws != nullptr) {
    i = ws[3 * (size_t)b];
    j = ws[3 * (size_t)b + 1];
    state = ws[3 * (size_t)b + 2];
  }
  unsigned acc = 0xFF;
  while (i >= 0 && j >= 0) {
    const int r = i + j;
    if (r < jb.lo) break;
    const int kb = r >> 2;
    if (kb != cb) {
      jb.ob[cb] = (uint8_t)acc;
      for (int k = cb - 1; k > kb; --k) jb.ob[k] = 0xFF;
      cb = kb;
      acc = 0xFF;
    }
    const int force = forced(r, i, jb.qlb, jb.tlb);
    const int tmp =
        force >= 0 ? 0 : (int)jb.plo[(size_t)(r - jb.lo) * S_t + i];
    acc = put_op(acc, r, step(tmp, force, i, j, state));
  }
  jb.ob[cb] = (uint8_t)acc;
  for (int k = cb - 1; k >= b_lo; --k) jb.ob[k] = 0xFF;
  if (ws != nullptr) {
    ws[3 * (size_t)b] = i;
    ws[3 * (size_t)b + 1] = j;
    ws[3 * (size_t)b + 2] = state;
  }
}

// ---------------------------------------------------------------------------
// A warp per walker on a prefetched window
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// V bytes from global ``src`` to shared ``dst``, both V-aligned:
// asynchronously for V = 16 and 4, a plain copy for V = 1.
template <int V>
__device__ __forceinline__ void copy_async(uint8_t* dst, const uint8_t* src) {
  if constexpr (V == 1) {
    *dst = *src;
  } else {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const size_t g = __cvta_generic_to_global(src);
    if constexpr (V == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(g)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(g)
                   : "memory");
  }
}

// First lane of a patch pw bytes wide for a walker at lane i: the 16-lane
// boundary at or below i - (pw - 16) + 1, so that lanes (i - (pw - 16), i]
// are inside whatever the alignment.
__device__ __forceinline__ int patch_start(int i, int pw) {
  return max(0, i - (pw - 16) + 1) & ~15;
}

// Start the copy of the patch with top row T (a local row of the problem)
// and first lane a0 into ``buf`` (R rows of pw bytes, row d = local row
// T - d): one lane a row, V bytes a copy.  Rows below the tile's first and
// lanes past S_t are left alone; the walker never reads them.
template <int R, int V>
__device__ __forceinline__ void fetch_patch(uint8_t* buf, const Job& jb,
                                            int S_t, int T, int a0, int pw,
                                            int ln) {
  for (int d = ln; d < R; d += 32) {
    const int row = T - d - jb.lo;
    if (row < 0) continue;
    const uint8_t* src = jb.plo + (size_t)row * S_t + a0;
    uint8_t* dst = buf + d * pw;
    const int n = min(pw, S_t - a0);  // a multiple of V: S_t and a0 are
    for (int col = 0; col + V <= n; col += V)
      copy_async<V>(dst + col, src + col);
  }
  cp_async_commit();
}

template <int R, int V>
__global__ void walk_window_kernel(const uint8_t* __restrict__ p,
                                   const int32_t* __restrict__ ql,
                                   const int32_t* __restrict__ tl,
                                   int32_t* __restrict__ ws,
                                   uint8_t* __restrict__ out, int B, int K,
                                   int S_q, int S_t, int n_bytes, int r0,
                                   int tile, int pw, int prefetch) {
  extern __shared__ int4 smem4[];
  const int ln = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp; the kernel has no block barrier
  Job jb;
  if (!job_of(b, p, ql, tl, out, K, S_q, S_t, n_bytes, r0, tile, jb)) return;
  // every byte of the call's rows is "not consumed" until lane 0 says so
  for (int k = (jb.lo >> 2) + ln; k < ((jb.hi + 3) >> 2); k += 32)
    jb.ob[k] = 0xFF;
  __syncwarp();
  if (!lengths_ok(jb.qlb, jb.tlb, S_q, S_t)) return;
  int i = jb.tlb - 1, j = jb.qlb - 1, state = 0;
  if (ws != nullptr) {
    i = ws[3 * (size_t)b];
    j = ws[3 * (size_t)b + 1];
    state = ws[3 * (size_t)b + 2];
  }
  // two patch buffers a warp: the one being walked and the one below
  uint8_t* bufs = reinterpret_cast<uint8_t*>(smem4) + (size_t)warp * 2 * R * pw;
  int cur = 0, T = 0, a0 = 0, Tn = 0, a0n = 0;
  bool have_next = false;
  int cb = -1;  // lane 0: the byte being assembled, none yet
  unsigned acc = 0xFF;
  for (;;) {
    const int r = i + j;
    if (i < 0 || j < 0 || r < jb.lo) break;  // warp-uniform
    if (have_next) {
      cp_async_wait_all();
      __syncwarp();
    }
    if (have_next && r <= Tn && r > Tn - R && i >= a0n && i < a0n + pw) {
      cur ^= 1;  // the patch below holds the walker
      T = Tn;
      a0 = a0n;
    } else {  // the first patch, or a guess the walker left
      T = r;
      a0 = patch_start(i, pw);
      fetch_patch<R, V>(bufs + cur * R * pw, jb, S_t, T, a0, pw, ln);
      cp_async_wait_all();
      __syncwarp();
    }
    have_next = prefetch && T - R >= jb.lo;
    if (have_next) {
      Tn = T - R;
      a0n = patch_start(i, pw);
      fetch_patch<R, V>(bufs + (cur ^ 1) * R * pw, jb, S_t, Tn, a0n, pw, ln);
    }
    if (ln == 0) {
      const uint8_t* buf = bufs + cur * R * pw;
      const int bottom = max(jb.lo, T - R + 1);  // the patch's last row
      if (i < jb.tlb && j < jb.qlb) {
        // i and j only fall, so a walker inside its problem (every walker
        // that started at the corner) stays inside every row's band and is
        // never forced.  Its byte's place in the patch moves with the step:
        // di + dj rows down, di lanes left.
        int idx = (T - (i + j)) * pw + (i - a0);
        while (i >= a0 && j >= 0 && i + j >= bottom) {  // a0 >= 0
          const int rr = i + j;
          const int kb = rr >> 2;
          if (kb != cb) {
            if (cb >= 0) jb.ob[cb] = (uint8_t)acc;
            cb = kb;
            acc = 0xFF;
          }
          const int tmp = buf[idx];
          const int s1 = (state != 0 && ((tmp >> (state + 2)) & 1))
                             ? state
                             : (tmp & 7);
          state = s1;
          const int di = s1 != 2;                // M and I consume the target
          const int dj = s1 == 0 || s1 == 2;     // M and D consume the query
          i -= di;
          j -= dj;
          idx += (di + dj) * pw - di;
          acc = put_op(acc, rr, 3 - 2 * di - dj);  // M 0, I 1, D 2
        }
      } else {
        while (i >= 0 && j >= 0) {
          const int rr = i + j;
          if (rr < bottom || i < a0) break;
          const int kb = rr >> 2;
          if (kb != cb) {
            if (cb >= 0) jb.ob[cb] = (uint8_t)acc;
            cb = kb;
            acc = 0xFF;
          }
          const int force = forced(rr, i, jb.qlb, jb.tlb);
          const int tmp = force >= 0 ? 0 : (int)buf[(T - rr) * pw + (i - a0)];
          acc = put_op(acc, rr, step(tmp, force, i, j, state));
        }
      }
    }
    __syncwarp();
    i = __shfl_sync(FULL, i, 0);
    j = __shfl_sync(FULL, j, 0);
    state = __shfl_sync(FULL, state, 0);
  }
  if (have_next) cp_async_wait_all();
  if (ln == 0) {
    if (cb >= 0) jb.ob[cb] = (uint8_t)acc;
    if (ws != nullptr) {
      ws[3 * (size_t)b] = i;
      ws[3 * (size_t)b + 1] = j;
      ws[3 * (size_t)b + 2] = state;
    }
  }
}

struct Args {
  const uint8_t* p;
  const int32_t *ql, *tl;
  int32_t* ws;
  uint8_t* out;
  int B, K, S_q, S_t, n_bytes, r0, tile;
  cudaStream_t cs;
};

template <int R, int V>
int launch_window(const Args& a, int pw, int prefetch, int warps) {
  auto kernel = walk_window_kernel<R, V>;
  const int smem = warps * 2 * R * pw;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused shape must not fail the next launch
    return (int)e;
  }
  kernel<<<(a.B + warps - 1) / warps, warps * 32, smem, a.cs>>>(
      a.p, a.ql, a.tl, a.ws, a.out, a.B, a.K, a.S_q, a.S_t, a.n_bytes, a.r0,
      a.tile, pw, prefetch);
  return (int)cudaGetLastError();
}

template <int R>
int launch_window_r(const Args& a, int pw, int prefetch, int warps) {
  // the widest copy the row stride and the base address allow
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.p);
  if (a.S_t % 16 == 0 && base % 16 == 0)
    return launch_window<R, 16>(a, pw, prefetch, warps);
  if (a.S_t % 4 == 0 && base % 4 == 0)
    return launch_window<R, 4>(a, pw, prefetch, warps);
  return launch_window<R, 1>(a, pw, prefetch, warps);
}

}  // namespace

extern "C" {

// Walk B = n_streams * K problems (problem k of stream s at index s * K +
// k) over stream rows [r0, r0 + tile) of p (n_streams, tile, S_t) uint8 and
// write those rows' packed bytes into out (B, n_bytes) uint8, n_bytes =
// ceil((S_q + S_t - 1) / 4).  ql / tl (B,) int32.  ``ws`` (B, 3) int32
// holds the walkers (i, j, state) in and out; null means the whole matrix
// (r0 = 0, tile = K * S_q + S_t - 1), walked from each problem's corner.
// R = 32 or 64: a warp per walker on patches of R rows, pw bytes a row (a
// multiple of 16 in [R + 16, 2 R + 16]), the patch below fetched ahead when
// ``prefetch``, ``warps`` walkers a block.  R = 0: one thread per walker.
// Launches on ``stream`` without synchronising; returns a CUDA error code.
int sedef_walk(const void* p, const void* ql, const void* tl, void* ws,
               void* out, int B, int K, int S_q, int S_t, int n_bytes, int r0,
               int tile, int R, int pw, int prefetch, int warps,
               void* stream) {
  if (K < 1 || S_q < 1 || S_t < 1 || tile < 1 || r0 < 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const Args a = {static_cast<const uint8_t*>(p),
                  static_cast<const int32_t*>(ql),
                  static_cast<const int32_t*>(tl),
                  static_cast<int32_t*>(ws),
                  static_cast<uint8_t*>(out),
                  B, K, S_q, S_t, n_bytes, r0, tile,
                  static_cast<cudaStream_t>(stream)};
  if (R == 0) {
    const int threads = 128;
    walk_thread_kernel<<<(B + threads - 1) / threads, threads, 0, a.cs>>>(
        a.p, a.ql, a.tl, a.ws, a.out, B, K, S_q, S_t, n_bytes, r0, tile);
    return (int)cudaGetLastError();
  }
  if ((R != 32 && R != 64) || pw % 16 || pw < R + 16 || pw > 2 * R + 16 ||
      warps < 1 || warps > 32 || (long long)warps * 2 * R * pw > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  return R == 32 ? launch_window_r<32>(a, pw, prefetch, warps)
                 : launch_window_r<64>(a, pw, prefetch, warps);
}

}  // extern "C"
