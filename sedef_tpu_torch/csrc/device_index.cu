// The device index build: one segment's winnowed minimizers (the closed
// form of ops/winnow.py) compacted in position order.
//
// Replaces _device_index (sedef_tpu/ops/winnow_device.py:84), a jit
// program; its plain PyTorch version is _device_index_torch in
// ops/winnow_device.py (k shift-ors, log-doubling window min and or, a
// cumsum and a scatter).  For each k-mer position p of the segment:
//   key[p]  = (status << 2k) | pack2(code[p .. p+k)), status HAS_N (2)
//             where a cls in the k-mer is 2, else HAS_UPPERCASE (0) where
//             one is 0, else ALL_LOWERCASE (1); uint32 arithmetic read as
//             int32, as the plain version's int32 shift-or wraps;
//   W[p]    = min(key[p-w .. p-1]), INF32 where that range is empty;
//   cmask   = key[p] <= W[p] and p < nk_valid;
//   start   = drop where drop > 0, else the last p <= w with cmask (-1
//             where none);
//   emit    = cmask and p >= start.
// Outputs: count (the number of emits, the true total even past cap),
// locs (cap,) the first cap emitted positions in order then nk, keys
// (cap,) their keys then INF32.
//
// What bounds it on the H100: the operations, a k-step pack and a w-step
// minimum a position (k 12, w 16 by default) over the 4 M positions of a
// segment; the bytes are the two code arrays, read once, and the cap-wide
// outputs.  The plain version makes some 2k + 2 log2 w passes over the
// segment in device memory.
//
// What the design does about it: a block per tile of TILE positions holds
// the tile's codes and classes with w + k - 1 of halo in shared memory,
// builds the tile's keys and the w before it there (a direct k-step loop),
// and takes each position's window minimum by a direct w-step loop over
// shared memory: exact for every w up to MAX_W < TILE, so the tile that
// holds p <= w, the first, also finds start.  The ordered compaction is
// three launches on the stream: each tile counts its emits; one block
// scans the tile counts (and writes count); each tile then recomputes its
// emits and writes them at its offset plus a block scan of contiguous
// runs, and the slots past count take nk and INF32.  No host sync.

#include <cuda_runtime.h>

#include <cstdint>

#include "row_sort.cuh"

namespace {

constexpr int TILE = 2048;               // k-mer positions a block
constexpr int THREADS = 256;
constexpr int PER = TILE / THREADS;      // contiguous positions a thread writes
constexpr int MAX_W = 1024;
constexpr int MAX_K = 14;                // the packed key fits in int32
constexpr int SCAN_THREADS = 1024;

struct IndexArgs {
  const uint8_t* code;
  const uint8_t* cls;
  int32_t* tile_count;  // (nb,)
  int32_t* tile_off;    // (nb,)
  int32_t* count;       // ()
  int32_t* locs;        // (cap,)
  int32_t* keys;        // (cap,)
  int n, nk, nk_valid, k, w, cap, drop, nb;
};

// The tile of block ``blockIdx.x``: keys_s[i] = key(base - w + i) for i in
// [0, TILE + w) (INF32 outside [0, nk)), emit_s[i] = emit(base + i) for i
// in [0, TILE).  Called by the whole block.
__device__ void tile_emits(const IndexArgs& a, int32_t* keys_s,
                           uint8_t* emit_s, uint8_t* code_s,
                           uint8_t* cls_s) {
  __shared__ int start_s;
  const int tid = threadIdx.x;
  const int base = blockIdx.x * TILE;
  const int lo = base - a.w;  // the first position held
  const int n_codes = TILE + a.w + a.k - 1;
  for (int i = tid; i < n_codes; i += THREADS) {
    const int q = lo + i;
    const bool in = q >= 0 && q < a.n;
    code_s[i] = in ? a.code[q] : 0;
    cls_s[i] = in ? a.cls[q] : 0;
  }
  if (tid == 0) start_s = -1;
  __syncthreads();
  for (int i = tid; i < TILE + a.w; i += THREADS) {
    const int q = lo + i;
    int32_t key = INF32;
    if (q >= 0 && q < a.nk) {
      uint32_t h = 0;
      bool has_n = false, has_u = false;
      for (int j = 0; j < a.k; ++j) {
        h = (h << 2) | code_s[i + j];
        has_n |= cls_s[i + j] == 2;
        has_u |= cls_s[i + j] == 0;
      }
      const uint32_t status = has_n ? 2u : (has_u ? 0u : 1u);
      key = static_cast<int32_t>((status << (2 * a.k)) | h);
    }
    keys_s[i] = key;
  }
  __syncthreads();
  // change points; the last one at p <= w (only the first tile has such p)
  int last = -1;
  for (int i = tid; i < TILE; i += THREADS) {
    const int p = base + i;
    bool c = false;
    if (p < a.nk && p < a.nk_valid) {
      int32_t m = INF32;
      for (int j = i; j < i + a.w; ++j) m = keys_s[j] < m ? keys_s[j] : m;
      c = keys_s[i + a.w] <= m;
      if (c && p <= a.w) last = p;  // i rises with the loop
    }
    emit_s[i] = c;
  }
  if (last >= 0) atomicMax(&start_s, last);
  __syncthreads();
  const int start = a.drop > 0 ? a.drop : start_s;
  if (start > base) {  // block-uniform
    for (int i = tid; i < TILE && base + i < start; i += THREADS)
      emit_s[i] = 0;
    __syncthreads();
  }
}

struct Smem {
  int32_t* keys;
  uint8_t* emit;
  uint8_t* code;
  uint8_t* cls;
};

__device__ __forceinline__ Smem carve(unsigned char* raw, const IndexArgs& a) {
  Smem s;
  s.keys = reinterpret_cast<int32_t*>(raw);
  s.emit = raw + sizeof(int32_t) * (TILE + a.w);
  s.code = s.emit + TILE;
  s.cls = s.code + TILE + a.w + a.k - 1;
  return s;
}

__global__ void __launch_bounds__(THREADS) index_count_kernel(IndexArgs a) {
  extern __shared__ unsigned char raw[];
  __shared__ int red[32];
  const Smem s = carve(raw, a);
  tile_emits(a, s.keys, s.emit, s.code, s.cls);
  int c = 0;
  for (int i = threadIdx.x; i < TILE; i += THREADS) c += s.emit[i];
  c = group_sum<THREADS>(c, threadIdx.x, red);
  if (threadIdx.x == 0) a.tile_count[blockIdx.x] = c;
}

// one block: tile_off = the exclusive scan of tile_count, count = its sum
__global__ void __launch_bounds__(SCAN_THREADS) index_scan_kernel(IndexArgs a) {
  __shared__ int red[32];
  const int per = (a.nb + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < a.nb ? lo + per : a.nb;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a.tile_count[i];
  int before = group_exclusive<SCAN_THREADS>(sum, threadIdx.x, red);
  for (int i = lo; i < hi; ++i) {
    a.tile_off[i] = before;
    before += a.tile_count[i];
  }
  if (threadIdx.x == SCAN_THREADS - 1) *a.count = before;
}

__global__ void __launch_bounds__(THREADS) index_write_kernel(IndexArgs a) {
  extern __shared__ unsigned char raw[];
  __shared__ int red[32];
  const Smem s = carve(raw, a);
  tile_emits(a, s.keys, s.emit, s.code, s.cls);
  const int tid = threadIdx.x;
  const int base = blockIdx.x * TILE;
  const int i0 = tid * PER;
  int c = 0;
#pragma unroll
  for (int e = 0; e < PER; ++e) c += s.emit[i0 + e];
  int slot = a.tile_off[blockIdx.x] + group_exclusive<THREADS>(c, tid, red);
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    if (s.emit[i0 + e]) {
      if (slot < a.cap) {
        a.locs[slot] = base + i0 + e;
        a.keys[slot] = s.keys[i0 + e + a.w];
      }
      ++slot;
    }
  }
  // the slots past the count
  const int total = *a.count;
  for (long g = static_cast<long>(blockIdx.x) * THREADS + tid; g < a.cap;
       g += static_cast<long>(gridDim.x) * THREADS) {
    if (g >= total) {
      a.locs[g] = a.nk;
      a.keys[g] = INF32;
    }
  }
}

}  // namespace

extern "C" {

// One segment's minimizers.  code, cls (n,) uint8; tile_count, tile_off
// (nb,) int32 scratch, nb = ceil((n - k + 1) / TILE), TILE = 2,048;
// writes count () int32, locs and keys (cap,) int32.  1 <= k <= 14,
// 1 <= w <= 1,024, n >= k.  Three launches on ``stream`` without
// synchronising; returns a CUDA error code.
int sedef_device_index(const void* code, const void* cls, void* tile_count,
                       void* tile_off, void* count, void* locs, void* keys,
                       int n, int nk_valid, int k, int w, int cap, int drop,
                       int nb, void* stream) {
  if (k < 1 || k > MAX_K || w < 1 || w > MAX_W || n < k || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nk = n - k + 1;
  if (nb != (nk + TILE - 1) / TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  const IndexArgs p = {static_cast<const uint8_t*>(code),
                       static_cast<const uint8_t*>(cls),
                       static_cast<int32_t*>(tile_count),
                       static_cast<int32_t*>(tile_off),
                       static_cast<int32_t*>(count),
                       static_cast<int32_t*>(locs),
                       static_cast<int32_t*>(keys),
                       n, nk, nk_valid, k, w, cap, drop, nb};
  const size_t smem = sizeof(int32_t) * (TILE + w) + TILE +
                      2 * static_cast<size_t>(TILE + w + k - 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  index_count_kernel<<<nb, THREADS, smem, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  index_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  index_write_kernel<<<nb, THREADS, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
