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
//   sedef_fill_streamed         wavefront_pipelined_batch (_pipe_dp_row)
// All fills compute the same bytes on every band lane of the same layout.
// The recurrence is the one in the docstring of
// sedef_tpu_torch/ops/wavefront.py (ksw2 extz2's difference encoding,
// rotated so that row r is anti-diagonal r and lane t is target index t);
// the cell is dp_cell of dp_cell.cuh in the warp and the owned-lane fill,
// and the same statements written out in the streamed template.
//
// Streams.  A stream is K problems of one (S_q, S_t) class, run back to
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
// The streamed fill: one block per stream, threads striding over a row's
// band so neighbouring threads store neighbouring bytes, the state (u, y in
// place; x, v ping-ponged by row parity because lane t reads the t-1
// neighbour of the previous row) in shared memory with the stream's codes
// whenever 24 * S_t + K * (S_q + S_t) bytes fit, otherwise in a global
// scratch slab per stream (L2-resident).  Streams remove the band's ramp-up
// and ramp-down rows (~S_q + S_t rows per problem become ~S_q).

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

template <bool SMEM>
__global__ void fill_streamed_kernel(const int8_t* __restrict__ qseq,
                                     const int8_t* __restrict__ tgt,
                                     uint8_t* __restrict__ p,
                                     int32_t* __restrict__ scratch, int K,
                                     int S_q, int S_t, int match, int mis,
                                     int gapo, int qe2, int max_sc) {
  extern __shared__ int32_t smem[];
  const int s = blockIdx.x;
  const int Q = K * S_q;  // the stream's query length
  int32_t* st = SMEM ? smem : scratch + (size_t)s * 6 * S_t;
  int32_t* U = st;            // u at lane t (in place)
  int32_t* Y = st + S_t;      // y at lane t (in place)
  int32_t* X = st + 2 * S_t;  // x, two row-parity planes
  int32_t* V = st + 4 * S_t;  // v, two row-parity planes
  const int8_t* qg = qseq + (size_t)s * Q;
  const int8_t* tg = tgt + (size_t)s * K * S_t;
  const int8_t* qs = qg;
  const int8_t* ts = tg;
  if (SMEM) {
    int8_t* codes = reinterpret_cast<int8_t*>(smem + 6 * S_t);
    for (int k = threadIdx.x; k < K * S_t; k += blockDim.x) codes[k] = tg[k];
    for (int k = threadIdx.x; k < Q; k += blockDim.x)
      codes[K * S_t + k] = qg[k];
    ts = codes;
    qs = codes + K * S_t;
  }
  __syncthreads();
  const int n_rows = Q + S_t - 1;
  uint8_t* pb = p + (size_t)s * n_rows * S_t;

  for (int r = 0; r < n_rows; ++r) {
    const int st0 = max(0, r - Q + 1);
    const int en0 = min(r, S_t - 1);
    const int32_t* Xp = X + ((r & 1) ^ 1) * S_t;
    const int32_t* Vp = V + ((r & 1) ^ 1) * S_t;
    int32_t* Xc = X + (r & 1) * S_t;
    int32_t* Vc = V + (r & 1) * S_t;
    uint8_t* prow = pb + (size_t)r * S_t;
    for (int t = st0 + threadIdx.x; t <= en0; t += blockDim.x) {
      const int m = r - t;  // in [0, Q) inside the band
      const int k = m / S_q;
      const int j = m - k * S_q;
      const int xs = t == 0 ? 0 : Xp[t - 1];
      const int vs = t == 0 ? (j > 0 ? gapo : 0) : Vp[t - 1];
      const int ub = j == 0 ? (t > 0 ? gapo : 0) : U[t];
      const int yb = j == 0 ? 0 : Y[t];
      const int qc = qs[m];
      const int tc = ts[k * S_t + t];
      const int sc = (qc >= 4 || tc >= 4) ? 0 : (qc == tc ? match : mis);
      int z = sc + qe2;
      const int a = xs + vs;
      const int bb = yb + ub;
      int d = a > z ? 1 : 0;
      z = max(z, a);
      d = bb > z ? 2 : d;
      z = max(z, bb);
      z = min(z, max_sc);
      const int z2 = z - gapo;
      const int a2 = a - z2;
      const int b2 = bb - z2;
      U[t] = z - vs;
      Y[t] = max(b2, 0);
      Vc[t] = z - ub;
      Xc[t] = max(a2, 0);
      d |= (a2 > 0 ? 8 : 0) | (b2 > 0 ? 16 : 0);
      prow[t] = (uint8_t)d;
    }
    __syncthreads();
  }
}

constexpr long long SMEM_MAX = 227LL * 1024;

}  // namespace

extern "C" {

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
  const long long smem = 24LL * S_t + S_q;  // six int32 planes and the query
  if (S_q < 1 || S_t < 1 || S_t % sedef::LPT || S_t > 1024 * sedef::LPT ||
      smem > SMEM_MAX || (unroll != 2 && unroll != 4))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const int qe2 = 2 * (gapo + gape);
  const Score s = {match, mis, gapo, qe2, match + qe2};
  auto kernel =
      unroll == 2 ? sedef::fill_owned<false, 2> : sedef::fill_owned<false, 4>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const int threads = (S_t / sedef::LPT + 31) / 32 * 32;
  kernel<<<B, threads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qseq), static_cast<const int8_t*>(tgt),
      static_cast<uint8_t*>(p), S_q, S_t, s);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory a streamed fill needs to keep its state
// and the stream's codes on chip, or 0 when they must live in global memory
// (the caller then passes a (n_streams, 6, S_t) int32 scratch slab).
int sedef_fill_smem_bytes(int K, int S_q, int S_t) {
  const long long need = 24LL * S_t + (long long)K * (S_q + S_t);
  return need <= SMEM_MAX ? (int)need : 0;
}

// Streamed fill.  qseq (n_streams * K, S_q), tgt (n_streams * K, S_t),
// problem k of stream s at row s * K + k; p (n_streams, K * S_q + S_t - 1,
// S_t) uint8.  Launches on ``stream`` without synchronising; returns
// cudaGetLastError().
int sedef_fill_streamed(const void* qseq, const void* tgt, void* p,
                        void* scratch, int n_streams, int K, int S_q,
                        int S_t, int match, int mis, int gapo, int gape,
                        int threads, void* stream) {
  const int qe2 = 2 * (gapo + gape);
  const int max_sc = match + qe2;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (n_streams <= 0) return (int)cudaGetLastError();
  const int8_t* q = static_cast<const int8_t*>(qseq);
  const int8_t* t = static_cast<const int8_t*>(tgt);
  uint8_t* pp = static_cast<uint8_t*>(p);
  const int smem = sedef_fill_smem_bytes(K, S_q, S_t);
  if (smem > 0) {
    cudaFuncSetAttribute(fill_streamed_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fill_streamed_kernel<true><<<n_streams, threads, smem, cs>>>(
        q, t, pp, nullptr, K, S_q, S_t, match, mis, gapo, qe2, max_sc);
  } else {
    fill_streamed_kernel<false><<<n_streams, threads, 0, cs>>>(
        q, t, pp, static_cast<int32_t*>(scratch), K, S_q, S_t, match, mis,
        gapo, qe2, max_sc);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
