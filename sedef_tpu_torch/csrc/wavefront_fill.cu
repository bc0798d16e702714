// Fills of the anti-diagonal affine-gap global DP: direct and streamed.
//
// Replaces, by entry point (TPU kernels in sedef_tpu/ops/wavefront.py):
//   sedef_fill                  wavefront_pallas_batch (body _dp_row)
//   sedef_fill_streamed         wavefront_pipelined_batch (_pipe_dp_row)
// Both run one template, fill_kernel; the checkpoint / tile-refill pair of
// the tiled route (tile_fill_cluster.cu) computes the same bytes on every
// band lane of the same layout.  The recurrence is the one in the
// docstring of sedef_tpu_torch/ops/wavefront.py (ksw2 extz2's difference
// encoding, rotated so that row r is anti-diagonal r and lane t is target
// index t).
//
// Streams.  A block owns one stream of K problems of one (S_q, S_t) class,
// run back to back in the same lanes and staggered by S_q rows (K = 1 is
// the direct fill): stream row r, lane t belongs to problem k = m / S_q at
// query index j = m % S_q, m = r - t, for 0 <= m < K * S_q.  Lane t hands
// over from problem k to k + 1 exactly when k's band leaves it, so the
// triangles tile the rotated plane.  Problem k's direction rows are stream
// rows [k * S_q, k * S_q + S_q + S_t - 1) in the direct layout.  A cell
// reads only cells of its own problem or a boundary injection, which is a
// function of j alone: the top row (j == 0) sees (u, y) = (t ? q : 0, 0),
// lane -1 sees (x, v) = (0, j ? q : 0).
//
// Layout: p is (n_streams, n_rows, S_t) uint8, n_rows = K * S_q + S_t - 1
// (wavefront_np's layout for K = 1, no sublane/lane packing).  Only lanes of
// a row's band are written; the traceback never reads others.  The tiled
// route's tile is (n_streams, tile, S_t) of the same rows, its checkpoint
// the state entering a tile, (n_streams, n_tiles, 4, S_t) int32 planes u, y,
// x, v.
//
// What bounds it on the H100: 29 integer operations per band cell (6 for
// the score, 17 for the recurrence, 6 for the direction flags) and one byte
// stored, one dependency step per anti-diagonal.  At every batch size the
// integer instruction rate, not the byte stream, is the bound; at small
// batch the chain of rows is what is felt: a block is one SM, a row's
// instructions pass through its four schedulers, and a 60 Kbp problem
// (123 K rows) keeps one SM busy for seconds.  What the design does about
// it: threads stride over a row's band so neighbouring threads store
// neighbouring bytes (coalesced); the state (u, y in place; x, v
// ping-ponged by row parity because lane t reads the t-1 neighbour of the
// previous row) lives in shared memory, with the stream's codes, whenever
// 24 * S_t + K * (S_q + S_t) bytes fit, otherwise in a global scratch slab
// per stream (L2-resident).  Streams remove the band's ramp-up and
// ramp-down rows (~S_q + S_t rows per problem become ~S_q).  The max chains
// are plain integer max/min: the direction byte needs the strict '>' tests
// in order, which a DPX max intrinsic does not report.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool SMEM, bool STREAM>
__global__ void fill_kernel(const int8_t* __restrict__ qseq,
                            const int8_t* __restrict__ tgt,
                            uint8_t* __restrict__ p,
                            int32_t* __restrict__ scratch, int K, int S_q,
                            int S_t, int match, int mis, int gapo, int qe2,
                            int max_sc) {
  extern __shared__ int32_t smem[];
  const int s = blockIdx.x;
  const int Kp = STREAM ? K : 1;
  const int Q = Kp * S_q;  // the stream's query length
  int32_t* st = SMEM ? smem : scratch + (size_t)s * 6 * S_t;
  int32_t* U = st;            // u at lane t (in place)
  int32_t* Y = st + S_t;      // y at lane t (in place)
  int32_t* X = st + 2 * S_t;  // x, two row-parity planes
  int32_t* V = st + 4 * S_t;  // v, two row-parity planes
  const int8_t* qg = qseq + (size_t)s * Q;
  const int8_t* tg = tgt + (size_t)s * Kp * S_t;
  const int8_t* qs = qg;
  const int8_t* ts = tg;
  if (SMEM) {
    int8_t* codes = reinterpret_cast<int8_t*>(smem + 6 * S_t);
    for (int k = threadIdx.x; k < Kp * S_t; k += blockDim.x) codes[k] = tg[k];
    for (int k = threadIdx.x; k < Q; k += blockDim.x)
      codes[Kp * S_t + k] = qg[k];
    ts = codes;
    qs = codes + Kp * S_t;
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
      const int k = STREAM ? m / S_q : 0;
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

template <bool STREAM>
int launch(const void* qseq, const void* tgt, void* p, void* scratch,
           int n_streams, int K, int S_q, int S_t, int match, int mis,
           int gapo, int gape, int threads, int smem, void* stream) {
  const int qe2 = 2 * (gapo + gape);
  const int max_sc = match + qe2;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (n_streams <= 0) return (int)cudaGetLastError();
  const int8_t* q = static_cast<const int8_t*>(qseq);
  const int8_t* t = static_cast<const int8_t*>(tgt);
  uint8_t* pp = static_cast<uint8_t*>(p);
  if (smem > 0) {
    cudaFuncSetAttribute(fill_kernel<true, STREAM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fill_kernel<true, STREAM><<<n_streams, threads, smem, cs>>>(
        q, t, pp, nullptr, K, S_q, S_t, match, mis, gapo, qe2, max_sc);
  } else {
    fill_kernel<false, STREAM><<<n_streams, threads, 0, cs>>>(
        q, t, pp, static_cast<int32_t*>(scratch), K, S_q, S_t, match, mis,
        gapo, qe2, max_sc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a fill needs to keep its state and the
// stream's codes on chip, or 0 when they must live in global memory (the
// caller then passes a (n_streams, 6, S_t) int32 scratch slab).
int sedef_fill_smem_bytes(int K, int S_q, int S_t) {
  const long long need = 24LL * S_t + (long long)K * (S_q + S_t);
  return need <= 227LL * 1024 ? (int)need : 0;
}

// Direct fill.  qseq (B, S_q) int8, tgt (B, S_t) int8 (wildcard 4 padded),
// p (B, S_q + S_t - 1, S_t) uint8.  Launches on ``stream`` without
// synchronising; returns cudaGetLastError().
int sedef_fill(const void* qseq, const void* tgt, void* p, void* scratch,
               int B, int S_q, int S_t, int match, int mis, int gapo,
               int gape, int threads, void* stream) {
  return launch<false>(qseq, tgt, p, scratch, B, 1, S_q, S_t, match, mis,
                       gapo, gape, threads,
                       sedef_fill_smem_bytes(1, S_q, S_t), stream);
}

// Streamed fill.  qseq (n_streams * K, S_q), tgt (n_streams * K, S_t),
// problem k of stream s at row s * K + k; p (n_streams, K * S_q + S_t - 1,
// S_t) uint8.
int sedef_fill_streamed(const void* qseq, const void* tgt, void* p,
                        void* scratch, int n_streams, int K, int S_q,
                        int S_t, int match, int mis, int gapo, int gape,
                        int threads, void* stream) {
  return launch<true>(qseq, tgt, p, scratch, n_streams, K, S_q, S_t, match,
                      mis, gapo, gape, threads,
                      sedef_fill_smem_bytes(K, S_q, S_t), stream);
}

}  // extern "C"
