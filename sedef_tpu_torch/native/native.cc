// SPDX-License-Identifier: MIT
// Native host runtime for the TPU-native SD engine.
//
// C++ implementations of the sequential host-side hot paths, mirroring the
// (oracle-validated) Python modules exactly:
//   * sedef_winnow     — the quirky change-point scan of ops/winnow.py
//   * sedef_search     — stage-1 seed search of models/seeder.py
//                        (sliding-Jaccard sketch, candidate clustering,
//                        window rolling, 3-mode extension, tree dedup,
//                        uppercase/q-gram filters)
//   * sedef_chain      — anchor chaining DP of ops/chain.py
//   * sedef_backtrack  — wavefront CIGAR traceback of ops/wavefront.py
//
// The compute kernels (wavefront DP, batched scoring) stay on the TPU; this
// library replaces only the pointer-chasing host loops where Python is the
// bottleneck.  Build: python -m sedef_tpu.native.build

#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// Phase profiling (reference analog: the per-section cur_time()/elapsed()
// timers of common.h:49-54).  Nanosecond accumulators per search phase,
// queried via sedef_prof_get; overhead is two clock_gettime calls per
// *interval* (not per roll step), ~50 ns each.
// ---------------------------------------------------------------------------

namespace prof {
enum Phase { COLLECT = 0, CLUSTER, ROLL, REPLAY, EXTEND, FILTER, N_PHASE };
static std::atomic<int64_t> ns[N_PHASE];
static std::atomic<int64_t> roll_steps{0}, intervals{0}, survivors{0};

static inline int64_t now() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

struct Scope {
  Phase ph;
  int64_t t0;
  explicit Scope(Phase p) : ph(p), t0(now()) {}
  ~Scope() { ns[ph].fetch_add(now() - t0, std::memory_order_relaxed); }
};
}  // namespace prof

extern "C" {

// out: [collect, cluster, roll, replay, extend, filter] ns, then
// [roll_steps, intervals, survivors]
void sedef_prof_get(int64_t *out) {
  for (int i = 0; i < prof::N_PHASE; i++) out[i] = prof::ns[i].load();
  out[prof::N_PHASE + 0] = prof::roll_steps.load();
  out[prof::N_PHASE + 1] = prof::intervals.load();
  out[prof::N_PHASE + 2] = prof::survivors.load();
}

void sedef_prof_reset() {
  for (int i = 0; i < prof::N_PHASE; i++) prof::ns[i] = 0;
  prof::roll_steps = 0;
  prof::intervals = 0;
  prof::survivors = 0;
}

// ---------------------------------------------------------------------------
// Winnowing change-point scan (ops/winnow.py change_points_np)
// ---------------------------------------------------------------------------

// keys: packed (status, hash) per k-mer position.  Emits indices where the
// reference deque's front changes: key[p] <= min(key[max(q, p-w) .. p-1]).
int64_t sedef_winnow(const int64_t *keys, int64_t n, int w, int64_t *out) {
  if (n <= 0) return 0;
  int64_t cnt = 0;
  out[cnt++] = 0;
  int64_t q = 0;
  int64_t m = keys[0];
  // monotonic deque over the last w keys for the sliding window minimum
  std::vector<int64_t> dq_idx(n ? (size_t)std::min<int64_t>(n, w + 2) : 1);
  int head = 0, tail = 0;  // [head, tail)
  auto dq_push = [&](int64_t i) {
    while (tail > head && keys[dq_idx[(tail - 1) % dq_idx.size()]] >= keys[i])
      tail--;
    dq_idx[tail % dq_idx.size()] = i;
    tail++;
  };
  auto dq_front_expire = [&](int64_t lo) {
    while (tail > head && dq_idx[head % dq_idx.size()] < lo) head++;
  };
  // W[p] = min(keys[p-w .. p-1]); maintain deque over that window
  for (int64_t p = 1; p < n; p++) {
    dq_push(p - 1);
    dq_front_expire(p - w);
    int64_t kp = keys[p];
    int64_t bound;
    if (q > p - w) {
      bound = m;
    } else {
      bound = keys[dq_idx[head % dq_idx.size()]];
    }
    if (kp <= bound) {
      out[cnt++] = p;
      q = p;
      m = kp;
    } else if (kp < m) {
      m = kp;
    }
  }
  return cnt;
}

// Fused k-mer + winnow scan: computes each position's packed
// (status, hash) key inline and runs the change-point scan above WITHOUT
// materializing the full key array (125 Mbp => 1 GB of avoided traffic;
// measured 10.9 -> ~2.5 s for the kmer+winnow+gather phases of a
// 125 Mbp index build).  The deque stores (idx, key) pairs so no key is
// ever re-read.  Emits change-point indices + their keys; the caller
// slices from the last change point <= w exactly like sedef_winnow's
// consumer (ops/winnow.py).
int64_t sedef_winnow_fused(const uint8_t *code, const uint8_t *cls,
                           int64_t len, int k, int w, int64_t *cps_out,
                           int64_t *keys_out) {
  const int64_t n = len - k + 1;
  if (n <= 0) return 0;
  const int64_t mask = ((int64_t)1 << (2 * k)) - 1;
  const int shift = 2 * k;

  // rolling key state
  int64_t h = 0;
  int cnt_n = 0, cnt_u = 0;
  auto step = [&](int64_t i) {  // consume base i
    h = ((h << 2) | code[i]) & mask;
    cnt_n += cls[i] == 2;
    cnt_u += cls[i] == 0;
    if (i >= k) {
      cnt_n -= cls[i - k] == 2;
      cnt_u -= cls[i - k] == 0;
    }
  };
  auto key_at = [&]() -> int64_t {
    int64_t status = cnt_n ? 2 : (cnt_u ? 0 : 1);
    return (status << shift) | h;
  };

  for (int64_t i = 0; i < k - 1; i++) step(i);

  struct IK { int64_t idx, key; };
  std::vector<IK> dq((size_t)std::min<int64_t>(n, w + 2) + 1);
  const size_t dn = dq.size();
  int64_t head = 0, tail = 0;

  step(k - 1);
  int64_t prev_key = key_at();  // key at p-1 (start: p=1 -> key[0])
  int64_t cnt = 0;
  cps_out[cnt] = 0;
  keys_out[cnt] = prev_key;
  cnt++;
  int64_t q = 0;
  int64_t m = prev_key;
  for (int64_t p = 1; p < n; p++) {
    // push key[p-1]
    while (tail > head && dq[(tail - 1) % dn].key >= prev_key) tail--;
    dq[tail % dn] = IK{p - 1, prev_key};
    tail++;
    while (tail > head && dq[head % dn].idx < p - w) head++;
    step(p + k - 1);
    int64_t kp = key_at();
    int64_t bound = (q > p - w) ? m : dq[head % dn].key;
    if (kp <= bound) {
      cps_out[cnt] = p;
      keys_out[cnt] = kp;
      cnt++;
      q = p;
      m = kp;
    } else if (kp < m) {
      m = kp;
    }
    prev_key = kp;
  }
  return cnt;
}

// Stable LSD radix sort of (key, loc) minimizer pairs by key (locs are
// in ascending position order on input, so stability gives the exact
// np.argsort(kind="stable") posting order).  keys fit 2k+2 <= 31 bits
// and locs < 2^31: packed into uint64 (key << 32 | loc), 4 x 16-bit
// passes.  7M pairs: ~0.2 s vs ~2.2 s numpy argsort + gathers.
int64_t sedef_sort_minimizers(const int64_t *keys, const int32_t *locs,
                              int64_t n, int64_t *skeys_out,
                              int32_t *slocs_out) {
  if (n <= 0) return 0;
  std::vector<uint64_t> a((size_t)n), b((size_t)n);
  for (int64_t i = 0; i < n; i++)
    a[i] = ((uint64_t)(uint64_t)keys[i] << 32) | (uint32_t)locs[i];
  uint64_t *src = a.data(), *dst = b.data();
  // LSD over the KEY bits only (2 x 16-bit passes cover 2k+2 <= 31
  // bits); equal keys keep input order = ascending loc, so the packed
  // loc bits never need sorting
  for (int pass = 2; pass < 4; pass++) {
    const int sh = pass * 16;
    size_t cnt[65536] = {0};
    for (int64_t i = 0; i < n; i++) cnt[(src[i] >> sh) & 0xffff]++;
    size_t sum = 0;
    for (int bkt = 0; bkt < 65536; bkt++) {
      size_t c = cnt[bkt];
      cnt[bkt] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; i++)
      dst[cnt[(src[i] >> sh) & 0xffff]++] = src[i];
    std::swap(src, dst);
  }
  for (int64_t i = 0; i < n; i++) {
    skeys_out[i] = (int64_t)(src[i] >> 32);
    slocs_out[i] = (int32_t)(src[i] & 0xffffffffu);
  }
  return n;
}

// packed (status, hash) keys for every k-mer position
// (ops/winnow.py kmer_keys_np; NumPy int64 shift/or chains are ~100x slower
// than this single pass on some hosts)
int64_t sedef_kmer_keys(const uint8_t *code, const uint8_t *cls, int64_t len,
                        int k, int64_t *out) {
  int64_t n = len - k + 1;
  if (n <= 0) return 0;
  const int64_t mask = ((int64_t)1 << (2 * k)) - 1;
  int64_t h = 0;
  // rolling hash + rolling has-N / has-upper counts over the k-window
  int cnt_n = 0, cnt_u = 0;
  for (int64_t i = 0; i < len; i++) {
    h = ((h << 2) | code[i]) & mask;
    cnt_n += cls[i] == 2;
    cnt_u += cls[i] == 0;
    if (i >= k) {
      cnt_n -= cls[i - k] == 2;
      cnt_u -= cls[i - k] == 0;
    }
    if (i < k - 1) continue;
    int64_t status = cnt_n ? 2 : (cnt_u ? 0 : 1);
    out[i - k + 1] = (status << (2 * k)) | h;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Sliding-Jaccard sketch (ops/sliding.py SlidingJaccard)
// ---------------------------------------------------------------------------

struct Sketch {
  std::map<int64_t, char> store;
  std::map<int64_t, char>::iterator bnd;  // == end() when query empty
  int query_size = 0;
  int intersection = 0;
  int limit = 0;
  double tau_k;    // tau(MAX_EDIT_ERROR, k)
  int n_shift;     // 2*k, for the HAS_N status test

  explicit Sketch(double tau_k_, int n_shift_)
      : tau_k(tau_k_), n_shift(n_shift_) {
    bnd = store.end();
  }

  // the boundary iterator must be re-seated into the copied map
  Sketch(const Sketch &o)
      : store(o.store), query_size(o.query_size),
        intersection(o.intersection), limit(o.limit), tau_k(o.tau_k),
        n_shift(o.n_shift) {
    bnd = (o.bnd == o.store.end()) ? store.end() : store.find(o.bnd->first);
  }

  Sketch &operator=(const Sketch &o) {
    if (this == &o) return *this;
    store = o.store;
    query_size = o.query_size;
    intersection = o.intersection;
    limit = o.limit;
    tau_k = o.tau_k;
    n_shift = o.n_shift;
    bnd = (o.bnd == o.store.end()) ? store.end() : store.find(o.bnd->first);
    return *this;
  }

  int limit_for(int s) const {
    if (s <= 0) return 0;
    if (s == 1) return 1;
    return (int)std::ceil(s * tau_k) + 1;
  }

  int jaccard() const {
    return intersection >= limit ? intersection : intersection - limit;
  }

  bool add(int64_t h, int bit) {
    auto it = store.lower_bound(h);
    bool inserted = false;
    if (it != store.end() && it->first == h) {
      if (it->second & bit) return false;
      it->second |= (char)bit;
    } else {
      it = store.insert(it, {h, (char)bit});
      inserted = true;
    }
    if (query_size && it->first < bnd->first) {
      intersection += (it->second == 3);
      if (inserted) {
        intersection -= (bnd->second == 3);
        --bnd;
      }
    }
    return true;
  }

  bool remove(int64_t h, int bit) {
    auto it = store.lower_bound(h);
    if (it == store.end() || it->first != h || !(it->second & bit))
      return false;
    if (query_size && it->first <= bnd->first) {
      intersection -= (it->second == 3);
      if (it->second == bit) {
        ++bnd;
        if (bnd != store.end()) intersection += (bnd->second == 3);
      }
    }
    if (it->second == bit) {
      store.erase(it);
    } else {
      it->second &= (char)~bit;
    }
    return true;
  }

  void add_query(int64_t h) {
    if (!add(h, 1)) return;
    limit = limit_for(++query_size);
    if (bnd == store.end()) bnd = store.begin();
    else ++bnd;
    intersection += (bnd->second == 3);
  }

  void remove_query(int64_t h) {
    if (!remove(h, 1)) return;
    limit = limit_for(--query_size);
    if (bnd != store.end()) intersection -= (bnd->second == 3);
    if (bnd == store.begin()) bnd = store.end();
    else --bnd;
  }

  bool has_n(int64_t h) const { return (h >> n_shift) == 2; }

  void add_ref(int64_t h) {
    if (!has_n(h)) add(h, 2);
  }
  void remove_ref(int64_t h) {
    if (!has_n(h)) remove(h, 2);
  }
};

// ---------------------------------------------------------------------------
// Stage-1 seed search (models/seeder.py)
// ---------------------------------------------------------------------------

struct IndexView {
  const int64_t *keys;   // minimizer keys, locus order
  const int32_t *locs;
  int64_t nmin;
  const int64_t *skeys;  // keys sorted
  const int32_t *slocs;  // loci in skeys order
  int64_t threshold;
  const uint8_t *cls;    // per-base class (0 up, 1 low, 2 N)
  const uint8_t *code;   // per-base 2-bit code
  int64_t len;
  // optional 16-bit radix bucket index over skeys: bucket_lo[b] = first
  // skeys index with (key >> bucket_shift) >= b (65537 entries) — the
  // posting binary search shrinks from log2(nmin) probes over the full
  // array to a short scan within one bucket (ops/index.py
  // posting_buckets)
  const int32_t *bucket_lo = nullptr;
  int bucket_shift = 0;

  int find_minimizers(int32_t p) const {
    return (int)(std::lower_bound(locs, locs + nmin, p) - locs);
  }
  // posting range for a key
  void posting(int64_t key, int64_t *lo, int64_t *hi) const {
    const int64_t *base = skeys;
    const int64_t *end = skeys + nmin;
    if (bucket_lo) {
      int64_t b = key >> bucket_shift;
      base = skeys + bucket_lo[b];
      end = skeys + bucket_lo[b + 1];
    }
    *lo = std::lower_bound(base, end, key) - skeys;
    *hi = std::upper_bound(base, end, key) - skeys;
  }
};

struct Rect {
  int32_t qs, qe, rs, re;
};

struct SearchParams {
  int kmer_size;
  double tau_k;          // tau(MAX_EDIT_ERROR, k)
  int min_read_size;     // 700
  int max_sd_size;       // 1<<20
  double max_error;      // 0.30
  double max_edit_error; // 0.15
  double gap_frequency;  // 0.005
  int min_uppercase;     // 12
  int do_uppercase;      // flags
  int do_qgram;
  int do_uppercase_seeds;
  int same_genome;
};

struct OutHit {
  int32_t qs, qe, rs, re, jaccard;
};

struct Counters {
  int64_t total = 0, jaccard = 0, interval = 0, lowercase = 0, qgram = 0;
};

static bool tree_covers(const std::vector<Rect> &tree, int32_t q, int32_t r) {
  for (const auto &t : tree)
    if (t.qs <= q && q < t.qe && t.rs <= r && r < t.re) return true;
  return false;
}

static bool is_overlap(const std::vector<Rect> &tree, int32_t pf_pos,
                       int32_t pf_end, int32_t pfp_pos, int32_t pfp_end,
                       const SearchParams &P) {
  for (const auto &t : tree) {
    if (!(t.qs <= pf_pos && pf_pos < t.qe && t.rs <= pfp_pos &&
          pfp_pos < t.re))
      continue;
    if (pf_pos >= t.qs && pf_end <= t.qe && pfp_pos >= t.rs &&
        pfp_end <= t.re)
      return true;
    if (std::min(t.qe - t.qs, t.re - t.rs) < P.min_read_size * 1.5) continue;
    if (t.qe - pf_pos >= P.min_read_size && t.re - pfp_pos >= P.min_read_size)
      return true;
  }
  return false;
}

// uppercase + q-gram filter (ops/filter.py filter_hit)
static bool filter_hit(const IndexView &Q, int32_t qs, int32_t qe,
                       const IndexView &R, int32_t rs, int32_t re,
                       const SearchParams &P, Counters &C) {
  if (P.do_uppercase) {
    int64_t qu = 0, ru = 0;
    for (int32_t i = qs; i < qe; i++) qu += (Q.cls[i] == 0);
    for (int32_t i = rs; i < re; i++) ru += (R.cls[i] == 0);
    if (qu < P.min_uppercase || ru < P.min_uppercase) {
      C.lowercase++;
      return false;
    }
  }
  if (P.do_qgram) {
    const int QG = 5;
    const int QSZ = 1 << (2 * QG);
    int maxlen = std::max(qe - qs, re - rs);
    int minqg = (int)(maxlen * (1 - (P.max_error - P.max_edit_error) -
                                QG * P.max_edit_error) -
                      (P.gap_frequency * maxlen + 1) * (QG - 1));
    static thread_local std::vector<int32_t> hq(QSZ), hr(QSZ);
    std::fill(hq.begin(), hq.end(), 0);
    std::fill(hr.begin(), hr.end(), 0);
    uint32_t g = 0, mask = QSZ - 1;
    for (int32_t i = qs; i < qe; i++) {
      g = ((g << 2) | Q.code[i]) & mask;
      if (i - qs >= QG - 1) hq[g]++;
    }
    g = 0;
    for (int32_t i = rs; i < re; i++) {
      g = ((g << 2) | R.code[i]) & mask;
      if (i - rs >= QG - 1) hr[g]++;
    }
    int64_t dist = 0;
    for (int i = 0; i < QSZ; i++) dist += std::min(hq[i], hr[i]);
    if (dist < minqg) {
      C.qgram++;
      return false;
    }
  }
  return true;
}

// 3-mode greedy extension (models/seeder.py extend / search.cc:95-259)
struct ExtState {
  int32_t qs, qe, rs, re;
  int64_t qws, qwe, rws, rwe;
};

static OutHit extend_hit(Sketch &w, const IndexView &Q, const IndexView &R,
                         ExtState st, const SearchParams &P) {
  const int64_t nq = Q.nmin, nr = R.nmin;
  auto q_right = [&]() {
    if (st.qwe >= nq) return false;
    w.add_query(Q.keys[st.qwe++]);
    st.qe = st.qwe < nq ? Q.locs[st.qwe] : (int32_t)Q.len;
    return true;
  };
  auto undo_q_right = [&]() {
    w.remove_query(Q.keys[--st.qwe]);
    st.qe = Q.locs[st.qwe];
  };
  auto r_right = [&]() {
    if (st.rwe >= nr) return false;
    w.add_ref(R.keys[st.rwe++]);
    st.re = st.rwe < nr ? R.locs[st.rwe] : (int32_t)R.len;
    return true;
  };
  auto undo_r_right = [&]() {
    w.remove_ref(R.keys[--st.rwe]);
    st.re = R.locs[st.rwe];
  };
  auto q_left = [&]() {
    if (!st.qws) return false;
    w.add_query(Q.keys[--st.qws]);
    st.qs = st.qws ? Q.locs[st.qws - 1] + 1 : 0;
    return true;
  };
  auto undo_q_left = [&]() {
    st.qs = Q.locs[st.qws] + 1;
    w.remove_query(Q.keys[st.qws++]);
  };
  auto r_left = [&]() {
    if (!st.rws) return false;
    w.add_ref(R.keys[--st.rws]);
    st.rs = st.rws ? R.locs[st.rws - 1] + 1 : 0;
    return true;
  };
  auto undo_r_left = [&]() {
    st.rs = R.locs[st.rws] + 1;
    w.remove_ref(R.keys[st.rws++]);
  };
  auto both_right = [&]() {
    if (st.rwe >= nr || st.qwe >= nq) return false;
    bool r = q_right();
    r &= r_right();
    return r;
  };
  auto undo_both_right = [&]() {
    undo_r_right();
    undo_q_right();
  };
  auto both_left = [&]() {
    if (!st.qws || !st.rws) return false;
    bool r = q_left();
    r &= r_left();
    return r;
  };
  auto undo_both_left = [&]() {
    undo_r_left();
    undo_q_left();
  };
  auto both_both = [&]() {
    if (!st.qws || !st.rws) return false;
    if (st.rwe >= nr || st.qwe >= nq) return false;
    bool r = both_left();
    r &= both_right();
    return r;
  };
  auto undo_both_both = [&]() {
    undo_both_right();
    undo_both_left();
  };

  st.qs = st.qws ? Q.locs[st.qws - 1] + 1 : 0;
  st.qe = st.qwe < nq ? Q.locs[st.qwe] : (int32_t)Q.len;
  st.rs = st.rws ? R.locs[st.rws - 1] + 1 : 0;
  st.re = st.rwe < nr ? R.locs[st.rwe] : (int32_t)R.len;

  const double max_gap_error = P.max_error - P.max_edit_error;
  for (;;) {
    int64_t max_match =
        P.same_genome
            ? std::min<int64_t>(
                  P.max_sd_size,
                  (int64_t)((1.0 / max_gap_error + .5) *
                            std::abs((int64_t)st.qs - (int64_t)st.rs)))
            : P.max_sd_size;
    int64_t aln_len = std::max(st.qe - st.qs, st.re - st.rs);
    int64_t seq_len = std::min(st.qe - st.qs, st.re - st.rs);
    if (aln_len > max_match ||
        100.0 * seq_len / aln_len < 100 * (1 - 2 * max_gap_error))
      break;
    if (P.same_genome) {
      int64_t overlap = st.qe - st.rs;
      if (overlap > 0 &&
          100.0 * overlap / (st.re - st.rs) > 100 * P.max_error)
        break;
    }
    bool extended = false;
    // order: both_both, both_right, both_left
    if (both_both()) {
      if (w.jaccard() >= 0) extended = true;
      else undo_both_both();
    }
    if (!extended && both_right()) {
      if (w.jaccard() >= 0) extended = true;
      else undo_both_right();
    }
    if (!extended && both_left()) {
      if (w.jaccard() >= 0) extended = true;
      else undo_both_left();
    }
    if (!extended) break;
  }
  return OutHit{st.qs, st.qe, st.rs, st.re, w.jaccard()};
}

// dev: optional device roll verdict [best_jaccard, best_steps] from the
// batched TPU roll engine (ops/roll_engine.py) — the interval's op stream
// is identical, so the scan is skipped and only the winning prefix is
// replayed.  null -> scalar roll here.
static void search_interval(int32_t query_start, int64_t qws, int64_t qwe,
                            const IndexView &Q, const IndexView &R,
                            std::vector<Rect> &tree, int init_len,
                            const Sketch &winnow0, int32_t t_start,
                            int32_t t_end, const SearchParams &P,
                            Counters &C, std::vector<OutHit> &hits,
                            const int32_t *dev = nullptr) {
  C.total++;
  prof::intervals.fetch_add(1, std::memory_order_relaxed);
  const int64_t nr = R.nmin;
  int32_t ref_start = t_start;
  int32_t ref_end = (int32_t)std::min<int64_t>(t_start + init_len, R.len);
  int64_t rws = Q.len ? R.find_minimizers(ref_start) : 0;
  int64_t rwe = rws;
  Sketch w = winnow0;
  int64_t t_roll = prof::now();
  while (rwe < nr && R.locs[rwe] < ref_end) w.add_ref(R.keys[rwe++]);

  // roll to best (reference records best coords PRE-increment and feeds the
  // first filter the FINAL scan coords; see models/seeder.py)
  Sketch init_w = w;
  const int32_t init_rs = ref_start, init_re = ref_end;
  const int64_t init_rws = rws, init_rwe = rwe;
  int best_j = w.jaccard();
  int64_t best_steps = 0;
  int32_t final_rs, final_re;
  if (dev) {
    // scan already done on device; n_steps is deterministic
    int64_t n_steps =
        ref_end < (int32_t)R.len
            ? std::max<int64_t>(
                  0, std::min<int64_t>(t_end - t_start,
                                       (int64_t)R.len - ref_end))
            : 0;
    best_j = dev[0];
    best_steps = dev[1];
    final_rs = (int32_t)(t_start + n_steps);
    final_re = (int32_t)(init_re + n_steps);
  } else {
    int64_t steps = 0;
    while (ref_start < t_end && ref_end < R.len) {
      if (rws < nr && R.locs[rws] < ref_start + 1)
        w.remove_ref(R.keys[rws++]);
      if (rwe < nr && R.locs[rwe] == ref_end) w.add_ref(R.keys[rwe++]);
      steps++;
      if (w.jaccard() > best_j) {
        best_j = w.jaccard();
        best_steps = steps;
      }
      ref_start++;
      ref_end++;
      if (ref_end == R.len) break;
    }
    final_rs = ref_start;
    final_re = ref_end;
    prof::roll_steps.fetch_add(steps, std::memory_order_relaxed);
  }
  prof::ns[prof::ROLL].fetch_add(prof::now() - t_roll,
                                 std::memory_order_relaxed);

  // replay to the best round
  int64_t t_replay = prof::now();
  w = init_w;
  ref_start = init_rs;
  ref_end = init_re;
  rws = init_rws;
  rwe = init_rwe;
  for (int64_t i = 0; i < best_steps; i++) {
    if (rws < nr && R.locs[rws] < ref_start + 1) w.remove_ref(R.keys[rws++]);
    if (rwe < nr && R.locs[rwe] == ref_end) w.add_ref(R.keys[rwe++]);
    ref_start++;
    ref_end++;
  }
  if (best_steps) {
    ref_start--;
    ref_end--;
  }
  prof::ns[prof::REPLAY].fetch_add(prof::now() - t_replay,
                                   std::memory_order_relaxed);

  if (w.jaccard() < 0) {
    C.jaccard++;
    return;  // report_fails always false in production
  }
  prof::survivors.fetch_add(1, std::memory_order_relaxed);
  if (is_overlap(tree, query_start, query_start + init_len, ref_start,
                 ref_end, P)) {
    C.interval++;
    return;
  }
  {
    prof::Scope sc(prof::FILTER);
    if (!filter_hit(Q, query_start, query_start + init_len, R, final_rs,
                    std::min<int32_t>(final_re, (int32_t)R.len), P, C))
      return;
  }
  ExtState st{query_start, query_start + init_len, ref_start, ref_end,
              qws, qwe, rws, rwe};
  int64_t t_ext = prof::now();
  OutHit h = extend_hit(w, Q, R, st, P);
  prof::ns[prof::EXTEND].fetch_add(prof::now() - t_ext,
                                   std::memory_order_relaxed);
  prof::Scope sc(prof::FILTER);
  if (!filter_hit(Q, h.qs, h.qe, R, h.rs, h.re, P, C)) return;
  hits.push_back(h);
  tree.push_back(Rect{h.qs, h.qe, h.rs, h.re});
}

// Candidate collection + clustering for one query window
// (search.cc:407-452).  tree == nullptr skips the dedup probes
// (speculative plan mode; see sedef_search_plan).  Returns the distinct
// window-key count and fills T with the (same_genome-clamped, t0<=t1)
// intervals in ascending order.
static int collect_intervals(const IndexView &Q, const IndexView &R,
                             const std::vector<Rect> *tree, int64_t qi,
                             int32_t query_start, const SearchParams &P,
                             int64_t *qwe_out,
                             std::vector<std::pair<int32_t, int32_t>> &T) {
  const int n_shift = 2 * P.kmer_size;
  static thread_local std::vector<int64_t> wkeys;
  wkeys.clear();
  static thread_local std::vector<int32_t> cand_v;
  cand_v.clear();
  int64_t t_collect = prof::now();
  int64_t qwe = qi;
  while (qwe < Q.nmin && Q.locs[qwe] - query_start <= P.min_read_size) {
    int64_t key = Q.keys[qwe];
    wkeys.push_back(key);
    qwe++;
    if (P.do_uppercase_seeds && (key >> n_shift) != 0) continue;
    int64_t lo, hi;
    R.posting(key, &lo, &hi);
    int64_t sz = hi - lo;
    if (sz == 0 || sz >= R.threshold) continue;
    int32_t qloc = Q.locs[qwe - 1];
    for (int64_t pi = lo; pi < hi; pi++) {
      int32_t pos = R.slocs[pi];
      if (!P.same_genome || pos >= query_start + P.min_read_size) {
        if (!tree || !tree_covers(*tree, qloc, pos)) cand_v.push_back(pos);
      }
    }
  }
  *qwe_out = qwe;
  std::sort(wkeys.begin(), wkeys.end());
  int distinct =
      (int)(std::unique(wkeys.begin(), wkeys.end()) - wkeys.begin());
  prof::ns[prof::COLLECT].fetch_add(prof::now() - t_collect,
                                    std::memory_order_relaxed);
  T.clear();
  if (!distinct) return 0;
  int64_t t_cluster = prof::now();
  std::sort(cand_v.begin(), cand_v.end());
  cand_v.erase(std::unique(cand_v.begin(), cand_v.end()), cand_v.end());
  int limit;  // Sketch::limit_for(distinct)
  if (distinct <= 0) limit = 0;
  else if (distinct == 1) limit = 1;
  else limit = (int)std::ceil(distinct * P.tau_k) + 1;
  for (int64_t i = 0; i <= (int64_t)cand_v.size() - limit; i++) {
    int64_t j = i + limit - 1;
    if (cand_v[j] - cand_v[i] <= P.min_read_size) {
      int32_t x = std::max(0, cand_v[j] - P.min_read_size + 1);
      int32_t y = cand_v[i] + 1;
      if (!T.empty() && x < T.back().second)
        T.back().second = std::max(T.back().second, y);
      else
        T.push_back({x, y});
    }
  }
  // same_genome clamp + empty drop (applied identically in plan and
  // production so interval tuples match exactly)
  std::vector<std::pair<int32_t, int32_t>> keep;
  for (auto &t : T) {
    int32_t a = t.first;
    if (P.same_genome) a = std::max(a, query_start + P.min_read_size);
    if (a <= t.second) keep.push_back({a, t.second});
  }
  T.swap(keep);
  prof::ns[prof::CLUSTER].fetch_add(prof::now() - t_cluster,
                                    std::memory_order_relaxed);
  return distinct;
}

// Speculative stage-1 plan: enumerate every (window, candidate interval)
// the production pass can visit, with an EMPTY dedup tree and the
// deterministic stride.  Per window: [loc, qws, qwe, n_intervals]; per
// interval: [t0, t1, rws0, init_cnt, n_steps, re0] — everything the
// device roll engine needs.  Returns 0, or -1 when caps are too small.
int64_t sedef_search_plan(
    const int64_t *q_keys, const int32_t *q_locs, int64_t q_nmin,
    int64_t q_len,
    const int64_t *r_keys, const int32_t *r_locs, int64_t r_nmin,
    const int64_t *r_skeys, const int32_t *r_slocs, int64_t r_threshold,
    int64_t r_len,
    int kmer_size, double tau_k, int min_read_size, double max_error,
    int same_genome, int do_uppercase_seeds,
    const int32_t *r_bucket_lo, int r_bucket_shift,
    int32_t *win_out, int64_t win_cap, int32_t *iv_out, int64_t iv_cap,
    int64_t *counts_out) {
  IndexView Q{q_keys, q_locs, q_nmin, nullptr, nullptr, 0,
              nullptr, nullptr, q_len};
  IndexView R{r_keys, r_locs, r_nmin, r_skeys, r_slocs, r_threshold,
              nullptr, nullptr, r_len, r_bucket_lo, r_bucket_shift};
  SearchParams P{};
  P.kmer_size = kmer_size;
  P.tau_k = tau_k;
  P.min_read_size = min_read_size;
  P.max_error = max_error;
  P.same_genome = same_genome;
  P.do_uppercase_seeds = do_uppercase_seeds;
  const int n_shift = 2 * kmer_size;
  const int32_t stride = (int32_t)(min_read_size * max_error) / 2;

  int64_t n_win = 0, n_iv = 0;
  int32_t next_to_attain = 0;
  std::vector<std::pair<int32_t, int32_t>> T;
  for (int64_t qi = 0; qi < q_nmin; qi++) {
    int32_t loc = q_locs[qi];
    if (loc < next_to_attain) continue;
    if (do_uppercase_seeds && (q_keys[qi] >> n_shift) != 0) continue;
    next_to_attain = loc + stride;  // min_len >= min_read always (see
                                    // sedef_search; desyncs are handled by
                                    // the loc merge-join there)
    int32_t nT = 0;
    int64_t qwe = qi;
    if (loc + min_read_size <= q_len) {
      int distinct = collect_intervals(Q, R, nullptr, qi, loc, P, &qwe, T);
      if (distinct) nT = (int32_t)T.size();
    }
    if (n_win + 1 > win_cap || n_iv + nT > iv_cap) return -1;
    win_out[n_win * 4 + 0] = loc;
    win_out[n_win * 4 + 1] = (int32_t)qi;
    win_out[n_win * 4 + 2] = (int32_t)qwe;
    win_out[n_win * 4 + 3] = nT;
    n_win++;
    for (int32_t t = 0; t < nT; t++) {
      int32_t t0 = T[t].first, t1 = T[t].second;
      int32_t rws0 = R.find_minimizers(t0);
      int32_t re0 = (int32_t)std::min<int64_t>(t0 + min_read_size, r_len);
      int64_t rwe0 = rws0;
      while (rwe0 < r_nmin && R.locs[rwe0] < re0) rwe0++;
      int64_t n_steps =
          re0 < (int32_t)r_len
              ? std::max<int64_t>(
                    0, std::min<int64_t>(t1 - t0, r_len - re0))
              : 0;
      iv_out[n_iv * 6 + 0] = t0;
      iv_out[n_iv * 6 + 1] = t1;
      iv_out[n_iv * 6 + 2] = rws0;
      iv_out[n_iv * 6 + 3] = (int32_t)(rwe0 - rws0);
      iv_out[n_iv * 6 + 4] = (int32_t)n_steps;
      iv_out[n_iv * 6 + 5] = re0;
      n_iv++;
    }
  }
  counts_out[0] = n_win;
  counts_out[1] = n_iv;
  return 0;
}

static void parse_hits(std::vector<OutHit> &hits) {
  std::vector<OutHit> keep;
  for (size_t i = 0; i < hits.size(); i++) {
    bool add = true;
    for (size_t j = 0; j < hits.size(); j++) {
      if (i != j && hits[i].rs >= hits[j].rs && hits[i].re <= hits[j].re &&
          hits[i].qs >= hits[j].qs && hits[i].qe <= hits[j].qe) {
        add = false;
        break;
      }
    }
    if (add) keep.push_back(hits[i]);
  }
  hits.swap(keep);
}

// Shared core of sedef_search / sedef_search_range: initial_search over
// the query minimizer index range [qi_lo, qi_hi) with an explicit
// sequential-state interface — incoming stride position (next_in) and
// incoming dedup-tree rectangles (tree_in) — and the symmetric outgoing
// state (next_out, tree_out).  Running the core over consecutive ranges,
// feeding each range the previous range's outgoing state, is EXACTLY the
// single full-range run: the loop carries no other cross-iteration state.
static int64_t search_core(
    // query index
    const int64_t *q_keys, const int32_t *q_locs, int64_t q_nmin,
    const int64_t *q_skeys, const int32_t *q_slocs, int64_t q_threshold,
    const uint8_t *q_cls, const uint8_t *q_code, int64_t q_len,
    // ref index
    const int64_t *r_keys, const int32_t *r_locs, int64_t r_nmin,
    const int64_t *r_skeys, const int32_t *r_slocs, int64_t r_threshold,
    const uint8_t *r_cls, const uint8_t *r_code, int64_t r_len,
    // params
    int kmer_size, double tau_k, int min_read_size, int max_sd_size,
    double max_error, double max_edit_error, double gap_frequency,
    int min_uppercase, int same_genome, int do_uppercase, int do_qgram,
    int do_uppercase_seeds,
    // optional device plan
    const int32_t *plan_win, int64_t n_plan_win,
    const int32_t *plan_iv, const int32_t *res_bj, const int32_t *res_bs,
    const uint8_t *res_ok,
    // query range + incoming sequential state
    int64_t qi_lo, int64_t qi_hi, int32_t next_in,
    const int32_t *tree_in, int64_t n_tree_in,
    // outgoing sequential state (may be null)
    int32_t *next_out, int32_t *tree_out, int64_t tree_cap,
    int64_t *n_tree_out,
    // optional 16-bit radix bucket index over the ref postings
    const int32_t *r_bucket_lo, int r_bucket_shift,
    // out
    int32_t *out, int64_t out_cap, int64_t *counters_out) {
  IndexView Q{q_keys, q_locs, q_nmin, q_skeys, q_slocs, q_threshold,
              q_cls, q_code, q_len};
  IndexView R{r_keys, r_locs, r_nmin, r_skeys, r_slocs, r_threshold,
              r_cls, r_code, r_len, r_bucket_lo, r_bucket_shift};
  SearchParams P{kmer_size,    tau_k,        min_read_size, max_sd_size,
                 max_error,    max_edit_error, gap_frequency, min_uppercase,
                 do_uppercase, do_qgram,     do_uppercase_seeds, same_genome};
  Counters C;
  const int n_shift = 2 * kmer_size;

  std::vector<Rect> tree;
  for (int64_t i = 0; i < n_tree_in; i++)
    tree.push_back(Rect{tree_in[i * 4 + 0], tree_in[i * 4 + 1],
                        tree_in[i * 4 + 2], tree_in[i * 4 + 3]});
  std::vector<OutHit> all;
  int32_t next_to_attain = next_in;

  // plan cursor: windows in both passes are visited in ascending loc
  // order, so a merge-join on loc pairs them up; iv_base tracks the
  // running interval offset of the skipped plan windows.
  int64_t wcur = 0, iv_base = 0;

  for (int64_t qi = qi_lo; qi < qi_hi; qi++) {
    int32_t loc = q_locs[qi];
    if (loc < next_to_attain) continue;
    if (do_uppercase_seeds && (q_keys[qi] >> n_shift) != 0) continue;

    // ---- search() (models/seeder.py search / search.cc:395-471) ----
    // Deferred-sketch optimization: the init window's sketch state is a
    // pure function of its distinct key set (query-only inserts are
    // order-independent), and the clustering limit needs only the
    // distinct count — so the (expensive) ordered map is built only when
    // a candidate cluster actually survives.  Results are identical.
    std::vector<OutHit> hits;
    int32_t query_start = loc;

    // pair this window with the plan (if any)
    const int32_t *pw = nullptr;
    int64_t piv0 = 0;
    if (plan_win) {
      while (wcur < n_plan_win && plan_win[wcur * 4] < loc) {
        iv_base += plan_win[wcur * 4 + 3];
        wcur++;
      }
      if (wcur < n_plan_win && plan_win[wcur * 4] == loc &&
          plan_win[wcur * 4 + 1] == (int32_t)qi) {
        pw = &plan_win[wcur * 4];
        piv0 = iv_base;
        iv_base += pw[3];
        wcur++;
      }
    }
    // the dedup tree can only have altered this window's candidates if
    // some stored rectangle overlaps its query range
    bool tree_free = true;
    for (const auto &t : tree)
      if (t.qs < query_start + min_read_size && t.qe > query_start) {
        tree_free = false;
        break;
      }

    if (query_start + min_read_size <= (int64_t)q_len) {
      Sketch init_w(tau_k, n_shift);
      bool sketch_built = false;
      int64_t qwe = qi;
      bool did_work = false;

      auto run_interval = [&](int32_t t0, int32_t t1, const int32_t *dev) {
        if (dev && dev[0] < 0) {
          // device-proven jaccard fail: no sketch, no roll, no replay
          C.total++;
          C.jaccard++;
          prof::intervals.fetch_add(1, std::memory_order_relaxed);
          return;
        }
        if (!sketch_built) {
          for (int64_t wi = qi; wi < qwe; wi++) init_w.add_query(q_keys[wi]);
          sketch_built = true;
        }
        search_interval(query_start, qi, qwe, Q, R, tree, min_read_size,
                        init_w, t0, t1, P, C, hits, dev);
      };

      if (pw && tree_free) {
        // plan is exact for this window: skip collect/cluster entirely
        qwe = pw[2];
        did_work = pw[3] > 0;
        for (int32_t t = 0; t < pw[3]; t++) {
          const int32_t *iv = &plan_iv[(piv0 + t) * 6];
          int32_t dev[2];
          const int32_t *devp = nullptr;
          if (res_ok && res_ok[piv0 + t]) {
            dev[0] = res_bj[piv0 + t];
            dev[1] = res_bs[piv0 + t];
            devp = dev;
          }
          run_interval(iv[0], iv[1], devp);
        }
      } else {
        static thread_local std::vector<std::pair<int32_t, int32_t>> T;
        int distinct =
            collect_intervals(Q, R, &tree, qi, query_start, P, &qwe, T);
        if (distinct) {
          did_work = !T.empty();
          // merge-join computed intervals against the plan's (both
          // ascend by t0); only exact (t0, t1) tuples may reuse verdicts
          int32_t pt = 0;
          for (auto &t : T) {
            const int32_t *devp = nullptr;
            int32_t dev[2];
            if (pw) {
              while (pt < pw[3] && plan_iv[(piv0 + pt) * 6] < t.first) pt++;
              if (pt < pw[3] &&
                  plan_iv[(piv0 + pt) * 6] == t.first &&
                  plan_iv[(piv0 + pt) * 6 + 1] == t.second &&
                  res_ok && res_ok[piv0 + pt]) {
                dev[0] = res_bj[piv0 + pt];
                dev[1] = res_bs[piv0 + pt];
                devp = dev;
              }
            }
            run_interval(t.first, t.second, devp);
          }
        }
      }
      if (did_work) {
        // tree -= [0, query_start - min_read_size)
        int32_t upto = query_start - min_read_size;
        if (upto > 0) {
          std::vector<Rect> keep;
          for (auto &r : tree)
            if (r.qe > upto) keep.push_back(r);
          tree.swap(keep);
        }
        parse_hits(hits);
      }
    }
    // ---- end search() ----

    int32_t min_len = (int32_t)q_len;
    for (auto &h : hits) {
      min_len = std::min(min_len, h.qe - h.qs);
      all.push_back(h);
    }
    next_to_attain =
        (min_len >= min_read_size
             ? loc + (int32_t)(min_read_size * max_error) / 2
             : loc);
  }

  counters_out[0] = C.total;
  counters_out[1] = C.jaccard;
  counters_out[2] = C.interval;
  counters_out[3] = C.lowercase;
  counters_out[4] = C.qgram;
  if (next_out) *next_out = next_to_attain;
  if (n_tree_out) {
    *n_tree_out = (int64_t)tree.size();
    if ((int64_t)tree.size() > tree_cap) return -(int64_t)all.size() - 1;
    for (size_t i = 0; i < tree.size(); i++) {
      tree_out[i * 4 + 0] = tree[i].qs;
      tree_out[i * 4 + 1] = tree[i].qe;
      tree_out[i * 4 + 2] = tree[i].rs;
      tree_out[i * 4 + 3] = tree[i].re;
    }
  }
  if ((int64_t)all.size() * 5 > out_cap) return -(int64_t)all.size() - 1;
  for (size_t i = 0; i < all.size(); i++) {
    out[i * 5 + 0] = all[i].qs;
    out[i * 5 + 1] = all[i].qe;
    out[i * 5 + 2] = all[i].rs;
    out[i * 5 + 3] = all[i].re;
    out[i * 5 + 4] = all[i].jaccard;
  }
  return (int64_t)all.size();
}

// full initial_search over a chromosome pair; returns hit count (or a
// negative value if out capacity is too small).  counters_out: int64[5].
//
// plan_win/plan_iv + res_*: optional speculative plan (sedef_search_plan)
// with device roll verdicts (ops/roll_engine.py).  Windows whose candidate
// set cannot have been altered by the dedup tree reuse the plan directly
// (collect skipped, device verdict applied); tree-touched or desynced
// windows fall back to the full scalar path.  Output is byte-identical
// either way.
int64_t sedef_search(
    // query index
    const int64_t *q_keys, const int32_t *q_locs, int64_t q_nmin,
    const int64_t *q_skeys, const int32_t *q_slocs, int64_t q_threshold,
    const uint8_t *q_cls, const uint8_t *q_code, int64_t q_len,
    // ref index
    const int64_t *r_keys, const int32_t *r_locs, int64_t r_nmin,
    const int64_t *r_skeys, const int32_t *r_slocs, int64_t r_threshold,
    const uint8_t *r_cls, const uint8_t *r_code, int64_t r_len,
    // params
    int kmer_size, double tau_k, int min_read_size, int max_sd_size,
    double max_error, double max_edit_error, double gap_frequency,
    int min_uppercase, int same_genome, int do_uppercase, int do_qgram,
    int do_uppercase_seeds,
    // optional device plan
    const int32_t *plan_win, int64_t n_plan_win,
    const int32_t *plan_iv, const int32_t *res_bj, const int32_t *res_bs,
    const uint8_t *res_ok,
    // optional ref posting bucket index
    const int32_t *r_bucket_lo, int r_bucket_shift,
    // out
    int32_t *out, int64_t out_cap, int64_t *counters_out) {
  return search_core(
      q_keys, q_locs, q_nmin, q_skeys, q_slocs, q_threshold, q_cls, q_code,
      q_len, r_keys, r_locs, r_nmin, r_skeys, r_slocs, r_threshold, r_cls,
      r_code, r_len, kmer_size, tau_k, min_read_size, max_sd_size,
      max_error, max_edit_error, gap_frequency, min_uppercase, same_genome,
      do_uppercase, do_qgram, do_uppercase_seeds, plan_win, n_plan_win,
      plan_iv, res_bj, res_bs, res_ok,
      0, q_nmin, 0, nullptr, 0, nullptr, nullptr, 0, nullptr,
      r_bucket_lo, r_bucket_shift,
      out, out_cap, counters_out);
}

// Query-range shard of initial_search (the multi-worker stage-1 unit):
// scans query minimizers [qi_lo, qi_hi) starting from the incoming
// sequential state (next_in stride position + tree_in dedup rectangles)
// and reports the outgoing state.  Chaining shards 0..C-1, each fed the
// previous shard's outgoing state, reproduces sedef_search byte for byte
// (the loop carries no other cross-iteration state); shards run
// SPECULATIVELY in parallel with a guessed incoming state and are
// revalidated/rerun by the Python driver (models/seeder.py
// sharded_pair_search).  No device-plan support (shards are a host path).
int64_t sedef_search_range(
    const int64_t *q_keys, const int32_t *q_locs, int64_t q_nmin,
    const int64_t *q_skeys, const int32_t *q_slocs, int64_t q_threshold,
    const uint8_t *q_cls, const uint8_t *q_code, int64_t q_len,
    const int64_t *r_keys, const int32_t *r_locs, int64_t r_nmin,
    const int64_t *r_skeys, const int32_t *r_slocs, int64_t r_threshold,
    const uint8_t *r_cls, const uint8_t *r_code, int64_t r_len,
    int kmer_size, double tau_k, int min_read_size, int max_sd_size,
    double max_error, double max_edit_error, double gap_frequency,
    int min_uppercase, int same_genome, int do_uppercase, int do_qgram,
    int do_uppercase_seeds,
    int64_t qi_lo, int64_t qi_hi, int32_t next_in,
    const int32_t *tree_in, int64_t n_tree_in,
    int32_t *next_out, int32_t *tree_out, int64_t tree_cap,
    int64_t *n_tree_out,
    const int32_t *r_bucket_lo, int r_bucket_shift,
    int32_t *out, int64_t out_cap, int64_t *counters_out) {
  return search_core(
      q_keys, q_locs, q_nmin, q_skeys, q_slocs, q_threshold, q_cls, q_code,
      q_len, r_keys, r_locs, r_nmin, r_skeys, r_slocs, r_threshold, r_cls,
      r_code, r_len, kmer_size, tau_k, min_read_size, max_sd_size,
      max_error, max_edit_error, gap_frequency, min_uppercase, same_genome,
      do_uppercase, do_qgram, do_uppercase_seeds, nullptr, 0, nullptr,
      nullptr, nullptr, nullptr,
      qi_lo, qi_hi, next_in, tree_in, n_tree_in,
      next_out, tree_out, tree_cap, n_tree_out,
      r_bucket_lo, r_bucket_shift,
      out, out_cap, counters_out);
}

// ---------------------------------------------------------------------------
// Wavefront CIGAR traceback (ops/wavefront.py backtrack_np)
// ---------------------------------------------------------------------------

// p: row-major (n_rows, stride) direction bytes; returns run count (ops in
// ops_out as 'M'/'D'/'I' bytes, lengths in lens_out), or -1 on overflow.
int64_t sedef_backtrack(const uint8_t *p, int64_t stride, int32_t qlen,
                        int32_t tlen, uint8_t *ops_out, int32_t *lens_out,
                        int64_t cap) {
  int64_t n = 0;
  auto push = [&](char op, int32_t ln) -> bool {
    if (n > 0 && (char)ops_out[n - 1] == op) {
      lens_out[n - 1] += ln;
      return true;
    }
    if (n >= cap) return false;
    ops_out[n] = (uint8_t)op;
    lens_out[n] = ln;
    n++;
    return true;
  };
  int32_t i = tlen - 1, j = qlen - 1;
  int state = 0;
  while (i >= 0 && j >= 0) {
    int64_t r = (int64_t)i + j;
    int32_t st0 = std::max(0, (int32_t)(r - qlen + 1));
    int32_t en0 = std::min((int32_t)r, tlen - 1);
    int force_state = -1;
    if (i < st0) force_state = 2;
    if (i > en0) force_state = 1;
    int tmp = force_state < 0 ? p[r * stride + i] : 0;
    if (state == 0) state = tmp & 7;
    else if (!((tmp >> (state + 2)) & 1)) state = 0;
    if (state == 0) state = tmp & 7;
    if (force_state >= 0) state = force_state;
    bool ok;
    if (state == 0) {
      ok = push('M', 1);
      i--;
      j--;
    } else if (state == 1 || state == 3) {
      ok = push('I', 1);
      i--;
    } else {
      ok = push('D', 1);
      j--;
    }
    if (!ok) return -1;
  }
  if (i >= 0 && !push('I', i + 1)) return -1;
  if (j >= 0 && !push('D', j + 1)) return -1;
  std::reverse(ops_out, ops_out + n);
  std::reverse(lens_out, lens_out + n);
  return n;
}

// ---------------------------------------------------------------------------
// Full wavefront DP + traceback for small host-side alignments
// (same recurrence as ops/wavefront.py wavefront_np; ksw2-equivalent)
// ---------------------------------------------------------------------------

// q/t: alignment-alphabet codes (0..3, 4=wildcard).  Emits CIGAR runs;
// returns run count or -1 on overflow.
//
// Explicit 64-lane int8 SIMD (GCC vector extensions -> AVX-512BW): the
// same difference recurrence as the Pallas kernel / ksw2, whose range
// invariants keep every value within int8.  State rows carry one guard
// byte before index 0 so the shifted reads xs[i] = x_prev[i-1] are plain
// unaligned loads; rows are padded 64 wide so blocks never mask.
typedef int8_t v64 __attribute__((vector_size(64), aligned(1)));

static inline v64 v_load(const int8_t *p) {
  v64 v;
  __builtin_memcpy(&v, p, 64);
  return v;
}
static inline void v_store(int8_t *p, v64 v) { __builtin_memcpy(p, &v, 64); }
static inline v64 v_splat(int8_t x) {
  v64 v;
  for (int i = 0; i < 64; i++) v[i] = x;
  return v;
}
static inline v64 v_sel(v64 m, v64 a, v64 b) { return (m & a) | (~m & b); }
static inline v64 v_max(v64 a, v64 b) { return v_sel(a > b, a, b); }
static inline v64 v_min(v64 a, v64 b) { return v_sel(a < b, a, b); }

int64_t sedef_align(const uint8_t *q, int32_t qlen, const uint8_t *t,
                    int32_t tlen, int match, int mis, int gapo, int gape,
                    uint8_t *ops_out, int32_t *lens_out, int64_t cap) {
  if (qlen <= 0 || tlen <= 0) return 0;
  const int qe = gapo + gape;
  const int qe2 = 2 * qe;
  const int max_sc = match + qe2;
  const int64_t n_diag = (int64_t)qlen + tlen - 1;
  const int64_t W = (int64_t)tlen + 80;  // padded row width

  // state rows with guard byte at [-1] (buffers offset by 1)
  std::vector<int8_t> ub(W + 1, 0), vb(W + 1, 0), xb(W + 1, 0), yb(W + 1, 0);
  std::vector<int8_t> ub2(W + 1, 0), vb2(W + 1, 0), xb2(W + 1, 0),
      yb2(W + 1, 0);
  int8_t *up = ub.data() + 1, *vp = vb.data() + 1, *xp = xb.data() + 1,
         *yp = yb.data() + 1;
  int8_t *uc = ub2.data() + 1, *vc = vb2.data() + 1, *xc = xb2.data() + 1,
         *yc = yb2.data() + 1;

  // padded target codes and reversed-padded query (qrow[i] = q[r - i])
  std::vector<int8_t> tpad(W, 4);
  for (int32_t i = 0; i < tlen; i++) tpad[i] = (int8_t)t[i];
  std::vector<int8_t> qrev((size_t)qlen + 2 * W, 4);
  for (int32_t jq = 0; jq < qlen; jq++)
    qrev[(size_t)W + qlen - 1 - jq] = (int8_t)q[jq];

  std::vector<uint8_t> p((size_t)n_diag * tlen);

  const v64 v_three = v_splat(3);
  const v64 v_match = v_splat((int8_t)match);
  const v64 v_mis = v_splat((int8_t)mis);
  const v64 v_qe2 = v_splat((int8_t)qe2);
  const v64 v_maxsc = v_splat((int8_t)max_sc);
  const v64 v_gapo = v_splat((int8_t)gapo);
  const v64 v_one = v_splat(1);
  const v64 v_two = v_splat(2);
  const v64 v_eight = v_splat(8);
  const v64 v_sixteen = v_splat(16);
  const v64 v_zero = v_splat(0);

  for (int64_t r = 0; r < n_diag; r++) {
    int32_t st0 = (int32_t)std::max<int64_t>(0, r - qlen + 1);
    int32_t en0 = (int32_t)std::min<int64_t>(r, tlen - 1);
    if (r < tlen) {
      up[r] = (int8_t)(r > 0 ? gapo : 0);
      yp[r] = 0;
    }
    up[-1] = 0;  // unused lane of the b-path at i == 0 is overwritten by
    yp[-1] = 0;  // the injection; guard values matter only for xs/vs
    xp[-1] = 0;
    vp[-1] = (int8_t)(r > 0 ? gapo : 0);

    const int8_t *qrow = &qrev[(size_t)W + qlen - 1 - r];  // qrow[i]=q[r-i]
    uint8_t *pr = &p[(size_t)r * tlen];
    for (int32_t i = st0; i <= en0; i += 64) {
      v64 qc = v_load(qrow + i);
      v64 tc = v_load(tpad.data() + i);
      v64 wild = (qc > v_three) | (tc > v_three);
      v64 sc = ~wild & v_sel(qc == tc, v_match, v_mis);
      v64 xs = v_load(xp + i - 1);
      v64 vs = v_load(vp + i - 1);
      v64 uprev = v_load(up + i);
      v64 yprev = v_load(yp + i);
      v64 z = sc + v_qe2;
      v64 a = xs + vs;
      v64 b = yprev + uprev;
      v64 d = (a > z) & v_one;
      z = v_max(z, a);
      d = v_sel(b > z, v_two, d);
      z = v_max(z, b);
      z = v_min(z, v_maxsc);
      v_store(uc + i, z - vs);
      v_store(vc + i, z - uprev);
      v64 z2 = z - v_gapo;
      v64 a2 = a - z2;
      v64 b2 = b - z2;
      v_store(xc + i, v_max(a2, v_zero));
      v_store(yc + i, v_max(b2, v_zero));
      d |= (a2 > v_zero) & v_eight;
      d |= (b2 > v_zero) & v_sixteen;
      // clip the store to the real row width (p rows are not padded)
      int n = en0 + 1 - i;
      if (n >= 64) {
        __builtin_memcpy(pr + i, &d, 64);
      } else {
        __builtin_memcpy(pr + i, &d, n);
      }
    }
    std::swap(up, uc);
    std::swap(vp, vc);
    std::swap(xp, xc);
    std::swap(yp, yc);
  }
  return sedef_backtrack(p.data(), tlen, qlen, tlen, ops_out, lens_out, cap);
}

// ---------------------------------------------------------------------------
// Anchor chaining DP (ops/chain.py chain_anchors)
// ---------------------------------------------------------------------------

namespace chain_dp {

constexpr int64_t MIN_SCORE = INT64_MIN / 4;

// priority-pointer segment tree with reference-equivalent tie propagation
struct PTree {
  std::vector<std::pair<int64_t, int32_t>> keys;  // (r_end-1, anchor idx)
  std::vector<int64_t> scores;
  std::vector<int32_t> ta, tp;
  std::vector<std::pair<int64_t, int32_t>> th;
  int64_t nsize;

  void init(std::vector<std::pair<std::pair<int64_t, int32_t>, int32_t>> &e) {
    std::sort(e.begin(), e.end());
    int64_t n = e.size();
    keys.resize(n);
    scores.assign(n, MIN_SCORE);
    for (int64_t i = 0; i < n; i++) keys[i] = e[i].first;
    int64_t size = 1;
    while (size < std::max<int64_t>(n, 1)) size <<= 1;
    nsize = 2 * size;
    ta.assign(nsize, -1);
    tp.assign(nsize, -1);
    th.assign(nsize, {0, 0});
    int64_t counter = 0;
    initr(0, 0, n, counter);
  }

  void initr(int64_t i, int64_t s, int64_t e, int64_t &counter) {
    if (i >= nsize) return;
    if (s + 1 == e) {
      ta[i] = (int32_t)counter;
      th[i] = keys[counter];
      counter++;
      return;
    }
    int64_t bnd = (s + e + 1) / 2;
    initr(2 * i + 1, s, bnd, counter);
    initr(2 * i + 2, bnd, e, counter);
    int64_t src = 2 * i + 1 + (2 * i + 2 < nsize ? 1 : 0);
    th[i] = th[src];
  }

  int64_t find_leaf(const std::pair<int64_t, int32_t> &key) const {
    int64_t leaf = 0;
    while (leaf < nsize &&
           (ta[leaf] == -1 || !(key == keys[ta[leaf]]))) {
      leaf = 2 * leaf + 1 + (key > th[2 * leaf + 1] ? 1 : 0);
    }
    return leaf;
  }

  void activate(const std::pair<int64_t, int32_t> &key, int64_t score) {
    int32_t leaf = (int32_t)find_leaf(key);
    scores[ta[leaf]] = score;
    int64_t i = 0;
    while (i < nsize) {
      if (tp[i] == -1 || scores[ta[leaf]] >= scores[ta[tp[i]]]) {
        int32_t t = tp[i];
        tp[i] = leaf;
        leaf = t;
      }
      if (leaf == -1) break;
      i = 2 * i + 1 + (keys[ta[leaf]] > th[2 * i + 1] ? 1 : 0);
    }
  }

  void deactivate(const std::pair<int64_t, int32_t> &key) {
    int32_t leaf = (int32_t)find_leaf(key);
    scores[ta[leaf]] = MIN_SCORE;
    int64_t i = 0;
    while (i < nsize) {
      if (tp[i] == -1) break;
      if (tp[i] == leaf) {
        if (ta[i] != -1) {
          tp[i] = -1;
          break;
        }
        int64_t l = 2 * i + 1, r = 2 * i + 2;
        if (r < nsize && tp[r] != -1 &&
            (tp[l] == -1 || scores[ta[tp[r]]] > scores[ta[tp[l]]])) {
          tp[i] = tp[r];
          leaf = tp[r];
          i = r;
        } else {
          tp[i] = tp[l];
          leaf = tp[l];
          i = l;
        }
        if (leaf == -1) break;
      } else {
        i = 2 * i + 1 + (key > th[2 * i + 1] ? 1 : 0);
      }
    }
  }

  int32_t rmqr(const std::pair<int64_t, int32_t> &p,
               const std::pair<int64_t, int32_t> &q, int64_t i) const {
    if (i >= nsize) return -1;
    if (ta[i] != -1) {
      const auto &k = keys[ta[i]];
      return (!(k < p) && !(q < k)) ? (int32_t)i : -1;
    }
    if (tp[i] == -1) return -1;
    const auto &k = keys[ta[tp[i]]];
    if (!(k < p) && !(q < k)) return tp[i];
    if (!(th[2 * i + 1] < q)) return rmqr(p, q, 2 * i + 1);
    if (th[2 * i + 1] < p) return rmqr(p, q, 2 * i + 2);
    int32_t m1 = rmqr(p, q, 2 * i + 1);
    int32_t m2 = rmqr(p, q, 2 * i + 2);
    if (m1 == -1) return m2;
    if (m2 == -1) return m1;
    return scores[ta[m1]] >= scores[ta[m2]] ? m1 : m2;
  }

  int32_t rmq(const std::pair<int64_t, int32_t> &p,
              const std::pair<int64_t, int32_t> &q) const {
    int32_t i = rmqr(p, q, 0);
    return i == -1 ? -1 : ta[i];
  }
};

}  // namespace chain_dp

// Exact k-mer anchor generation (ops/anchors.py / chain.cc:24-101
// semantics): hash-join of query/ref k-mers (case-insensitive 2-bit
// codes, N-containing k-mers excluded, posting lists of size >=
// max_posting skipped), greedy maximal exact-match extension along
// diagonals with the per-diagonal slide dedup, q-major emission.
// q/r: raw sequence bytes (ASCII).  Outputs 4 x int32 per anchor
// (q, r, len, has_u).  Returns anchor count, or -needed-1 on overflow.
int64_t sedef_anchors(const uint8_t *q, int64_t qlen, const uint8_t *r,
                      int64_t rlen, int same_chr, int64_t oqs, int64_t ors,
                      int k, int max_posting, int32_t *out,
                      int64_t out_cap) {
  const int64_t nq = qlen - k + 1, nr = rlen - k + 1;
  if (nq <= 0 || nr <= 0) return 0;
  auto code_of = [](uint8_t c) -> int32_t {
    switch (c) {
      case 'A': case 'a': return 0;
      case 'C': case 'c': return 1;
      case 'G': case 'g': return 2;
      case 'T': case 't': return 3;
      default: return 0;  // hash_dna maps everything else to 0
    }
  };
  auto upper_of = [](uint8_t c) -> uint8_t {
    return (c >= 'a' && c <= 'z') ? (uint8_t)(c - 32) : c;
  };
  auto is_n = [](uint8_t c) { return c == 'N' || c == 'n'; };

  // normalized compare buffers: toupper, N mapped to per-side sentinels
  // (so N always mismatches), 8 trailing pad bytes that mismatch each
  // other — the word-wise extension below stops at sequence ends
  // without explicit bounds checks.  Uppercase prefix sums give has_u
  // in O(1) per anchor.
  std::vector<uint8_t> qn(qlen + 8, 3), rn(rlen + 8, 5);
  std::vector<int32_t> puq(qlen + 1, 0), pur(rlen + 1, 0);
  for (int64_t i = 0; i < qlen; i++) {
    uint8_t c = q[i];
    qn[i] = is_n(c) ? 1 : upper_of(c);
    puq[i + 1] = puq[i] + (c >= 'A' && c <= 'Z');
  }
  for (int64_t i = 0; i < rlen; i++) {
    uint8_t c = r[i];
    rn[i] = is_n(c) ? 2 : upper_of(c);
    pur[i + 1] = pur[i] + (c >= 'A' && c <= 'Z');
  }

  // (hash << 32 | pos) of valid ref k-mers, grouped into contiguous
  // posting runs with pos ascending within a run.  Grouping is a
  // 2-pass counting scatter on the hash (O(nr), stable in pos since
  // positions are generated ascending) — std::sort was ~25% of the
  // small-region scan (measured r5).
  const int64_t mask = (1u << (2 * k)) - 1;
  std::vector<uint64_t> kv;
  kv.reserve(nr);
  {
    uint32_t h = 0;
    int last_n = -1;
    for (int64_t i = 0; i < rlen; i++) {
      if (is_n(r[i])) last_n = (int)i;
      h = (uint32_t)(((h << 2) | (uint32_t)code_of(r[i])) & mask);
      int64_t p = i - k + 1;
      if (p >= 0 && last_n < p)
        kv.push_back(((uint64_t)h << 32) | (uint64_t)p);
    }
  }
  if (kv.empty()) return 0;
  std::vector<uint64_t> rv(kv.size());
  {
    // bucket by the low 16 hash bits then insertion-group the (rare)
    // same-low-bits collisions? No — full grouping via two passes over
    // a cuckoo-free open-addressing counter keyed on the full hash
    // would need the table before the runs exist.  Simplest exact
    // stable grouping: LSD radix sort on the 2k-bit hash in two
    // 11-bit passes (pos order preserved by stability).
    const int SH = (2 * k + 1) / 2;  // split the 2k hash bits in half
    const int B1 = 1 << SH, B2 = 1 << (2 * k - SH);
    std::vector<uint64_t> tmp(kv.size());
    std::vector<int32_t> cnt(std::max(B1, B2) + 1, 0);
    // pass 1: low SH bits of hash
    for (uint64_t v : kv) cnt[((v >> 32) & (B1 - 1)) + 1]++;
    for (int i = 1; i <= B1; i++) cnt[i] += cnt[i - 1];
    for (uint64_t v : kv) tmp[cnt[(v >> 32) & (B1 - 1)]++] = v;
    // pass 2: high bits
    std::fill(cnt.begin(), cnt.begin() + B2 + 1, 0);
    for (uint64_t v : tmp) cnt[((v >> 32) >> SH) + 1]++;
    for (int i = 1; i <= B2; i++) cnt[i] += cnt[i - 1];
    for (uint64_t v : tmp) rv[cnt[(v >> 32) >> SH]++] = v;
  }

  // O(1) posting lookup.  Two regimes:
  //
  // * BIG ref (chromosome-scale, the stage-2a anchor scan of whole
  //   merge regions): epoch-stamped direct-address table over the
  //   2^(2k) hash space (k=11 -> 4M entries; the reference's
  //   unordered_map lookup is what made its per-core anchor scan beat
  //   the binary-searched sorted vector).  thread_local + epoch stamp:
  //   no per-call clearing.
  //
  // * SMALL ref (the dense-SD regime: ~15 Kbp align regions): the 16 MB
  //   direct table is cache-hostile — every query probe is a DRAM miss,
  //   ~150 ns x nq ~= 2.2 ms/region, 10x the real scan work (measured
  //   r5, hg19-density rehearsal).  A power-of-2 open-addressing table
  //   sized ~2x the distinct-kmer count stays L2-resident.
  if (2 * k > 24) return -2;  // direct table infeasible; caller must
                              // keep k <= 12 on the native path
  const size_t tbl_n = (size_t)1 << (2 * k);
  const bool small_mode = rv.size() < (1u << 17);
  static thread_local std::vector<uint32_t> tbl_ep;
  static thread_local std::vector<int32_t> tbl_lo, tbl_cnt;
  static thread_local uint32_t tbl_epoch = 0;
  // small-mode open addressing: key (kmer hash +1, 0 = empty) -> run
  static thread_local std::vector<uint32_t> oa_key;
  static thread_local std::vector<int32_t> oa_lo, oa_cnt;
  size_t oa_mask = 0;
  if (small_mode) {
    size_t want = 64;
    while (want < 2 * rv.size()) want <<= 1;
    oa_mask = want - 1;
    if (oa_key.size() < want) {
      oa_key.resize(want);
      oa_lo.resize(want);
      oa_cnt.resize(want);
    }
    std::fill(oa_key.begin(), oa_key.begin() + want, 0u);
    for (size_t i = 0; i < rv.size();) {
      uint32_t hh = (uint32_t)(rv[i] >> 32);
      size_t j = i;
      while (j < rv.size() && (uint32_t)(rv[j] >> 32) == hh) j++;
      size_t slot = (size_t)(hh * 2654435761u) & oa_mask;
      while (oa_key[slot] != 0) slot = (slot + 1) & oa_mask;
      oa_key[slot] = hh + 1;
      oa_lo[slot] = (int32_t)i;
      oa_cnt[slot] = (int32_t)(j - i);
      i = j;
    }
  } else {
    if (tbl_ep.size() < tbl_n) {
      tbl_ep.assign(tbl_n, 0);
      tbl_lo.resize(tbl_n);
      tbl_cnt.resize(tbl_n);
      tbl_epoch = 0;
    }
    if (++tbl_epoch == 0) {  // uint32 wrap: restamp
      std::fill(tbl_ep.begin(), tbl_ep.end(), 0u);
      tbl_epoch = 1;
    }
    for (size_t i = 0; i < rv.size();) {
      uint32_t hh = (uint32_t)(rv[i] >> 32);
      size_t j = i;
      while (j < rv.size() && (uint32_t)(rv[j] >> 32) == hh) j++;
      tbl_ep[hh] = tbl_epoch;
      tbl_lo[hh] = (int32_t)i;
      tbl_cnt[hh] = (int32_t)(j - i);
      i = j;
    }
  }

  // per-diagonal slide as an epoch-stamped flat array (diag in
  // [0, qlen + rlen))
  static thread_local std::vector<uint32_t> sl_ep;
  static thread_local std::vector<int64_t> sl_val;
  static thread_local uint32_t sl_epoch = 0;
  const size_t sl_n = (size_t)(qlen + rlen + 1);
  if (sl_ep.size() < sl_n) {
    sl_ep.assign(std::max(sl_n, sl_ep.size() * 2), 0);
    sl_val.resize(sl_ep.size());
    sl_epoch = 0;
  }
  if (++sl_epoch == 0) {  // uint32 wrap: restamp
    std::fill(sl_ep.begin(), sl_ep.end(), 0u);
    sl_epoch = 1;
  }

  std::vector<int32_t> anchors;  // flat (q, r, len, has_u)

  uint32_t h = 0;
  int last_n = -1;
  for (int64_t i = 0; i < qlen; i++) {
    if (is_n(q[i])) last_n = (int)i;
    h = (uint32_t)(((h << 2) | (uint32_t)code_of(q[i])) & mask);
    int64_t qp = i - k + 1;
    if (qp < 0 || last_n >= qp) continue;
    int64_t sz, lo_idx;
    if (small_mode) {
      size_t slot = (size_t)(h * 2654435761u) & oa_mask;
      while (oa_key[slot] != 0 && oa_key[slot] != h + 1)
        slot = (slot + 1) & oa_mask;
      if (oa_key[slot] == 0) continue;
      sz = oa_cnt[slot];
      lo_idx = oa_lo[slot];
    } else {
      if (tbl_ep[h] != tbl_epoch) continue;
      sz = tbl_cnt[h];
      lo_idx = tbl_lo[h];
    }
    if (sz >= max_posting) continue;  // chain.cc:61
    const uint64_t *lo = rv.data() + lo_idx;
    const uint64_t *hi = lo + sz;
    for (auto it = lo; it != hi; ++it) {
      int64_t rp = (int64_t)(*it & 0xffffffffull);
      if (same_chr &&
          std::llabs((ors + rp) - (oqs + qp)) <= k)
        continue;  // chain.cc:67-69 near-diagonal self matches
      int64_t diag = qlen + rp - qp;
      if (sl_ep[diag] == sl_epoch && qp < sl_val[diag]) continue;
      // greedy maximal exact extension: word-wise compare over the
      // normalized buffers (the differing pads stop it at either end)
      int64_t ln = 0;
      {
        const uint8_t *qa = qn.data() + qp;
        const uint8_t *ra = rn.data() + rp;
        for (;;) {
          uint64_t wq, wr;
          std::memcpy(&wq, qa + ln, 8);
          std::memcpy(&wr, ra + ln, 8);
          if (wq != wr) {
            uint64_t x = wq ^ wr;
            ln += (int64_t)(__builtin_ctzll(x) >> 3);
            break;
          }
          ln += 8;
        }
      }
      int has_u = (puq[qp + ln] - puq[qp]) + (pur[rp + ln] - pur[rp]) > 0
                      ? 1 : 0;
      if (ln < k) continue;  // N inside the seed window cannot happen
                             // (valid mask), but stay defensive
      if ((int64_t)anchors.size() + 4 > out_cap)
        return -((int64_t)anchors.size() / 4) - 1;
      anchors.push_back((int32_t)qp);
      anchors.push_back((int32_t)rp);
      anchors.push_back((int32_t)ln);
      anchors.push_back(has_u);
      sl_ep[diag] = sl_epoch;
      sl_val[diag] = qp + ln;
    }
  }
  std::memcpy(out, anchors.data(), anchors.size() * sizeof(int32_t));
  return (int64_t)anchors.size() / 4;
}

// anchors: (q, r, l, has_u) arrays; outputs: path (anchor indices) and
// boundaries (end offsets + has_u sums).  Returns number of boundaries,
// or -1 on overflow.
int64_t sedef_chain(const int32_t *aq, const int32_t *ar, const int32_t *al,
                    const int32_t *ahu, int64_t n, int max_chain_gap,
                    int match_chain_score, int32_t *path_out,
                    int64_t *bound_out, int64_t bound_cap) {
  using namespace chain_dp;
  if (n == 0) {
    if (bound_cap < 2) return -1;
    bound_out[0] = 0;
    bound_out[1] = 0;
    return 1;
  }
  std::vector<std::pair<std::pair<int64_t, int32_t>, int32_t>> xs;
  std::vector<std::pair<std::pair<int64_t, int32_t>, int32_t>> ys;
  xs.reserve(2 * n);
  ys.reserve(n);
  int64_t max_q = 0, max_r = 0;
  for (int64_t i = 0; i < n; i++) {
    xs.push_back({{aq[i], (int32_t)i}, (int32_t)i});
    xs.push_back({{aq[i] + al[i], (int32_t)i}, (int32_t)i});
    ys.push_back({{ar[i] + al[i] - 1, (int32_t)i}, (int32_t)i});
    max_q = std::max<int64_t>(max_q, aq[i] + al[i]);
    max_r = std::max<int64_t>(max_r, ar[i] + al[i]);
  }
  std::sort(xs.begin(), xs.end());
  PTree tree;
  {
    // PTree sorts ys and keeps payload order via pos[]
    std::vector<std::pair<std::pair<int64_t, int32_t>, int32_t>> e = ys;
    tree.init(e);
  }
  // pos[i]: sorted-entry -> original anchor
  std::vector<int32_t> pos(n);
  {
    std::vector<std::pair<std::pair<int64_t, int32_t>, int32_t>> e = ys;
    std::sort(e.begin(), e.end());
    for (int64_t i = 0; i < n; i++) pos[i] = e[i].second;
  }

  std::vector<int32_t> prev(n, -1);
  std::vector<int64_t> dp(n, 0);
  int64_t deactivate_bound = 0;
  for (int64_t xi = 0; xi < (int64_t)xs.size(); xi++) {
    int32_t i = xs[xi].second;
    if (xs[xi].first.first == aq[i]) {  // start event
      while (deactivate_bound < xi) {
        int32_t t = xs[deactivate_bound].second;
        int64_t tc = xs[deactivate_bound].first.first;
        if (tc == aq[t] + al[t]) {
          if (aq[i] - (aq[t] + al[t]) <= max_chain_gap) break;
          tree.deactivate({ar[t] + al[t] - 1, t});
        }
        deactivate_bound++;
      }
      int64_t w = (int64_t)match_chain_score * ahu[i] +
                  (match_chain_score / 2) * (int64_t)(al[i] - ahu[i]);
      int32_t j = tree.rmq({ar[i] - max_chain_gap, 0},
                           {ar[i] - 1, (int32_t)n});
      if (j != -1 && tree.scores[j] != MIN_SCORE) {
        int32_t pj = pos[j];
        int64_t gap = (int64_t)(aq[i] - (aq[pj] + al[pj])) +
                      (ar[i] - (ar[pj] + al[pj]));
        if (w + dp[pj] - gap > 0) {
          dp[i] = w + dp[pj] - gap;
          prev[i] = pj;
        } else {
          dp[i] = w;
        }
      } else {
        dp[i] = w;
      }
    } else {  // end event
      int64_t gap = (max_q + 1 - (aq[i] + al[i])) +
                    (max_r + 1 - (ar[i] + al[i]));
      tree.activate({ar[i] + al[i] - 1, i}, dp[i] - gap);
    }
  }

  std::vector<std::pair<int64_t, int32_t>> order(n);
  for (int64_t i = 0; i < n; i++) order[i] = {dp[i], (int32_t)i};
  std::sort(order.begin(), order.end(),
            std::greater<std::pair<int64_t, int32_t>>());

  std::vector<char> used(n, 0);
  int64_t plen = 0, nb = 0;
  bound_out[nb * 2 + 0] = 0;
  bound_out[nb * 2 + 1] = 0;
  nb++;
  for (auto &m : order) {
    int32_t maxi = m.second;
    if (used[maxi]) continue;
    int64_t hu = 0;
    while (maxi != -1 && !used[maxi]) {
      path_out[plen++] = maxi;
      hu += ahu[maxi];
      used[maxi] = 1;
      maxi = prev[maxi];
    }
    if (nb * 2 + 1 >= bound_cap) return -1;
    bound_out[nb * 2 + 0] = plen;
    bound_out[nb * 2 + 1] = hu;
    nb++;
  }
  return nb;
}

// Gapped-alignment materialization (align.cc:274-315 semantics): build
// the gapped strings + '|'/'*' midline + match/mismatch tallies from
// (a, b, cigar) in one pass.  The Python populate() was ~4.7 calls and
// ~0.4 ms per dense region of numpy slicing + string encode/decode
// (measured r5).  eq is case-insensitive and never true for '-'/'N'.
int64_t sedef_populate(const uint8_t *a, const uint8_t *b,
                       const uint8_t *ops, const int32_t *lens,
                       int64_t nops, uint8_t *ga, uint8_t *gb,
                       uint8_t *mid, int64_t total, int64_t *counts) {
  auto up = [](uint8_t c) -> uint8_t {
    return (c >= 'a' && c <= 'z') ? (uint8_t)(c - 32) : c;
  };
  int64_t ia = 0, ib = 0, pos = 0;
  int64_t matches = 0, mismatches = 0;
  for (int64_t o = 0; o < nops; o++) {
    uint8_t op = ops[o];
    int64_t ln = lens[o];
    if (pos + ln > total) return -1;
    if (op == 'M') {
      for (int64_t i = 0; i < ln; i++) {
        uint8_t ca = a[ia + i], cb = b[ib + i];
        ga[pos + i] = ca;
        gb[pos + i] = cb;
        uint8_t ua = up(ca), ub = up(cb);
        bool both = ca != '-' && cb != '-';
        bool eq = both && ua != 'N' && ub != 'N' && ua == ub;
        mid[pos + i] = eq ? '|' : '*';
        matches += eq;
        mismatches += both && !eq;
      }
      ia += ln;
      ib += ln;
    } else if (op == 'D') {
      for (int64_t i = 0; i < ln; i++) {
        ga[pos + i] = a[ia + i];
        gb[pos + i] = '-';
        mid[pos + i] = '*';
      }
      ia += ln;
    } else {  // 'I'
      for (int64_t i = 0; i < ln; i++) {
        ga[pos + i] = '-';
        gb[pos + i] = b[ib + i];
        mid[pos + i] = '*';
      }
      ib += ln;
    }
    pos += ln;
  }
  counts[0] = matches;
  counts[1] = mismatches;
  return pos;
}

// Batched scalar wavefront DP: nprob problems in concatenated buffers
// (offsets arrays of length nprob+1), run lists concatenated into
// ops_out/lens_out with per-problem counts in cnt_out.  One ctypes
// round trip instead of one per gap DP — the dense-SD regime issues
// ~20 sub-2 Kbp gap DPs per region and the per-call marshaling was
// ~25% of the align stage (measured r5).  Returns total runs or
// -(p+1) if problem p overflowed out_cap (caller regrows).
int64_t sedef_align_batch(const uint8_t *qbuf, const int64_t *qoff,
                          const uint8_t *tbuf, const int64_t *toff,
                          int64_t nprob, int match, int mis, int gapo,
                          int gape, uint8_t *ops_out, int32_t *lens_out,
                          int64_t *cnt_out, int64_t out_cap) {
  int64_t pos = 0;
  for (int64_t p = 0; p < nprob; p++) {
    int32_t ql = (int32_t)(qoff[p + 1] - qoff[p]);
    int32_t tl = (int32_t)(toff[p + 1] - toff[p]);
    int64_t room = out_cap - pos;
    if (room < (int64_t)ql + tl + 2) return -(p + 1);
    int64_t n = sedef_align(qbuf + qoff[p], ql, tbuf + toff[p], tl,
                            match, mis, gapo, gape, ops_out + pos,
                            lens_out + pos, room);
    if (n < 0) return -(p + 1);
    cnt_out[p] = n;
    pos += n;
  }
  return pos;
}

}  // extern "C"

// ===========================================================================
// Full-region align path (stage 2b): anchors -> chaining -> guided assembly
// -> O(n^2) chain refinement, entirely in native code.
//
// This is the dense-SD-regime fix (docs/HG19_DENSE.md): per ~10 Kbp region
// the Python glue around the (already native) anchor scan / chain DP / gap
// DPs — Alignment assembly, trims, merges, per-region Hit round trips —
// cost ~2.5 ms of GIL-bound interpreter time, which dominates exactly when
// regions are small and below the device-dispatch breakeven.  The semantics
// here are the pinned byte-parity semantics of models/aligner.py and
// ops/cigar.py (reference: src/chain.cc:203-268, src/refine.cc:23-193,
// src/align.cc), including the reference quirks those modules document
// (trim_front's sentinel collision, the '\0' CIGAR sentinel, the ma1-wins
// gap-join no-op, int()-truncating refine scores).  On any state the Python
// path would assert on — or a DP too big for the host (the device tiled
// kernel's regime) — we throw Bail and the caller falls back to the Python
// path for that region, so behaviour can never diverge.
// ===========================================================================

namespace region_align {

struct Bail {};  // fall back to the Python path for this region

struct Cig {
  char op;
  int64_t len;
};

struct RCfg {
  // align scores, signed as in config.py AlignParams (5, -4, -40, -1)
  int match, mis, gapo, gape;
  int k;
  int max_chain_gap, match_chain_score, min_uppercase_match;
  int min_read_size;
  double max_error;
  // refine params (floats in config.py RefineParams; int()-truncated use)
  double rf_match, rf_mismatch, rf_gap, rf_gapopen;
  int rf_min_read, rf_side_align, rf_max_gap;
};

// A gap DP bigger than this is the device tiled kernel's regime -> Bail.
static const int64_t MAX_DP_CELLS = (int64_t)1 << 28;

// 5-letter DP alphabet (ops/dna.py _ALIGN_LUT): ACGT any case -> 0..3,
// everything else (incl. N) -> 4 (wildcard, scores 0 in the kernel).
static inline uint8_t dp_code(uint8_t c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return 4;
  }
}

static std::vector<Cig> run_dp(const uint8_t *q, int64_t ql,
                               const uint8_t *t, int64_t tl,
                               const RCfg &cfg) {
  if (ql == 0 && tl == 0) return {};
  if (ql == 0) return {{'I', tl}};
  if (tl == 0) return {{'D', ql}};
  if ((ql + tl) * tl > MAX_DP_CELLS) throw Bail{};
  std::vector<uint8_t> qc(ql), tc(tl);
  for (int64_t i = 0; i < ql; i++) qc[i] = dp_code(q[i]);
  for (int64_t i = 0; i < tl; i++) tc[i] = dp_code(t[i]);
  int64_t cap = ql + tl + 2;
  std::vector<uint8_t> ops(cap);
  std::vector<int32_t> lens(cap);
  int64_t n = sedef_align(qc.data(), (int32_t)ql, tc.data(), (int32_t)tl,
                          cfg.match, cfg.mis, -cfg.gapo, -cfg.gape,
                          ops.data(), lens.data(), cap);
  if (n < 0) throw Bail{};
  std::vector<Cig> out((size_t)n);
  for (int64_t i = 0; i < n; i++) out[i] = {(char)ops[i], (int64_t)lens[i]};
  return out;
}

// Inter-block gap policy (align.cc:126-145; ops/cigar.py _batch_gap_cigars
// and _append_gap_cigar): both-sided small gaps -> full DP; big double
// gaps -> same-length-prefix DP plus ONE raw-appended indel op (possibly
// zero-length — the zero survives and shapes later coalescing); one-sided
// gaps -> pure indel.
static std::vector<Cig> gap_cigar(const uint8_t *q, const uint8_t *r,
                                  int64_t qpe, int64_t qs, int64_t rpe,
                                  int64_t rs, const RCfg &cfg) {
  int64_t qgap = qs - qpe, rgap = rs - rpe;
  if (qgap && rgap) {
    if (qgap <= 1000 && rgap <= 1000)
      return run_dp(q + qpe, qgap, r + rpe, rgap, cfg);
    int64_t mi = std::min(qgap, rgap), ma = std::max(qgap, rgap);
    auto cig = run_dp(q + qpe, mi, r + rpe, mi, cfg);
    cig.push_back({qgap == mi ? 'I' : 'D', ma - mi});
    return cig;
  }
  if (qgap) return {{'D', qgap}};
  if (rgap) return {{'I', rgap}};
  return {};
}

// Local-coordinate alignment state (ops/cigar.py Alignment semantics).
struct Aln {
  std::string a, b;                  // ungapped local substrings
  int64_t sa = 0, ea = 0, sb = 0, eb = 0;
  std::vector<Cig> cig;
  std::string ga, gb, mid;           // gapped strings + '|'/'*' midline
  int64_t matches = 0, mismatches = 0;

  int64_t span() const { return (int64_t)mid.size(); }
  int64_t gap_bases() const {
    int64_t s = 0;
    for (auto &c : cig)
      if (c.op != 'M') s += c.len;
    return s;
  }

  static inline char up(char c) {
    return (c >= 'a' && c <= 'z') ? (char)(c - 32) : c;
  }

  // align.cc:274-315 — gapped strings, midline, error tallies
  void populate() {
    int64_t total = 0;
    for (auto &c : cig) total += c.len;
    ga.resize(total);
    gb.resize(total);
    mid.resize(total);
    int64_t ia = 0, ib = 0, pos = 0;
    matches = mismatches = 0;
    for (auto &c : cig) {
      int64_t ln = c.len;
      if (c.op == 'M') {
        if (ia + ln > (int64_t)a.size() || ib + ln > (int64_t)b.size())
          throw Bail{};
        for (int64_t i = 0; i < ln; i++) {
          char ca = a[ia + i], cb = b[ib + i];
          ga[pos + i] = ca;
          gb[pos + i] = cb;
          char ua = up(ca), ub = up(cb);
          bool both = ca != '-' && cb != '-';
          bool eq = both && ua != 'N' && ub != 'N' && ua == ub;
          mid[pos + i] = eq ? '|' : '*';
          matches += eq;
          mismatches += both && !eq;
        }
        ia += ln;
        ib += ln;
      } else if (c.op == 'D') {
        if (ia + ln > (int64_t)a.size()) throw Bail{};
        for (int64_t i = 0; i < ln; i++) {
          ga[pos + i] = a[ia + i];
          gb[pos + i] = '-';
          mid[pos + i] = '*';
        }
        ia += ln;
      } else {  // 'I' (and the '\0' sentinel, always zero-length)
        if (ib + ln > (int64_t)b.size()) throw Bail{};
        for (int64_t i = 0; i < ln; i++) {
          ga[pos + i] = '-';
          gb[pos + i] = b[ib + i];
          mid[pos + i] = '*';
        }
        ib += ln;
      }
      pos += ln;
    }
  }

  void append_cigar(const std::vector<Cig> &app) {
    if (app.empty()) return;
    size_t start = 0;
    if (!cig.empty() && cig.back().op == app[0].op) {
      cig.back().len += app[0].len;
      start = 1;
    }
    cig.insert(cig.end(), app.begin() + start, app.end());
  }

  void prepend_cigar(const std::vector<Cig> &app) {
    if (app.empty()) return;
    if (!cig.empty() && cig.front().op == app.back().op) {
      cig.front().len += app.back().len;
      cig.insert(cig.begin(), app.begin(), app.end() - 1);
    } else {
      cig.insert(cig.begin(), app.begin(), app.end());
    }
  }

  // align.cc:480-501 incl. the empty-alignment '\0' sentinel run
  void cigar_from_alignment() {
    int64_t n = (int64_t)ga.size();
    cig.clear();
    if (n == 0) {
      cig.push_back({'\0', 0});
      return;
    }
    for (int64_t i = 0; i < n;) {
      char op = ga[i] == '-' ? 'I' : (gb[i] == '-' ? 'D' : 'M');
      int64_t j = i + 1;
      while (j < n &&
             (ga[j] == '-' ? 'I' : (gb[j] == '-' ? 'D' : 'M')) == op)
        j++;
      cig.push_back({op, j - i});
      i = j;
    }
  }

  // align.cc:343-456 trimming; per-column scores with gap opens charged
  // at the run edge the scan direction encounters (ops/cigar.py
  // _column_scores)
  std::vector<int64_t> column_scores(const RCfg &cfg, bool forward) const {
    int64_t n = span();
    std::vector<int64_t> sc(n);
    for (int64_t i = 0; i < n; i++) {
      bool gapA = ga[i] == '-', gapB = gb[i] == '-';
      bool isgap = gapA || gapB;
      int64_t s = mid[i] == '|' ? cfg.match : (!isgap ? cfg.mis : cfg.gape);
      bool open;
      if (forward) {
        open = (i == 0) ? isgap
                        : ((gapA && ga[i - 1] != '-') ||
                           (gapB && gb[i - 1] != '-'));
      } else {
        open = (i == n - 1) ? isgap
                            : ((gapA && ga[i + 1] != '-') ||
                               (gapB && gb[i + 1] != '-'));
      }
      sc[i] = s + ((open && isgap) ? cfg.gapo : 0);
    }
    return sc;
  }

  // Keep the max-scoring suffix.  Reference quirk reproduced: the
  // "trim everything" sentinel max_i = a.size() compares a GAPPED column
  // index with the ungapped length and can collide with a legitimate
  // positive-score cut (align.cc:345; pinned by
  // tests/test_aligner.py::test_trim_front_sentinel_collision_quirk).
  void trim_front(const RCfg &cfg) {
    int64_t n = span();
    auto sc = column_scores(cfg, false);
    int64_t gm = -1, max_i = -1;
    if (n) {
      int64_t acc = 0;
      std::vector<int64_t> rcum(n);
      for (int64_t i = n - 1; i >= 0; i--) {
        acc += sc[i];
        rcum[i] = acc;
      }
      gm = *std::max_element(rcum.begin(), rcum.end());
      if (gm >= 0)
        for (int64_t i = 0; i < n; i++)
          if (rcum[i] == gm) {
            max_i = i;
            break;
          }
    }
    if (n == 0 || gm < 0 || max_i == (int64_t)a.size()) {
      a.clear();
      b.clear();
      sa = ea;
      sb = eb;
      cig.clear();
      populate();
      return;
    }
    int64_t cur_len = 0;
    size_t ci = 0;
    while (ci < cig.size()) {
      char op = cig[ci].op;
      int64_t ln = cig[ci].len;
      if (ln + cur_len > max_i) {
        if (op != 'M') throw Bail{};
        int64_t need = max_i - cur_len;
        cig[ci].len = ln - need;
        cig.erase(cig.begin(), cig.begin() + ci);
        sa += need;
        sb += need;
        break;
      }
      cur_len += ln;
      if (op == 'M') {
        sa += ln;
        sb += ln;
      } else if (op == 'I') {
        sb += ln;
      } else {
        sa += ln;
      }
      ci++;
    }
    if (ea - sa < 0 || ea - sa > (int64_t)a.size() || eb - sb < 0 ||
        eb - sb > (int64_t)b.size())
      throw Bail{};
    a.erase(0, a.size() - (size_t)(ea - sa));
    b.erase(0, b.size() - (size_t)(eb - sb));
    populate();
  }

  // Keep the max-scoring prefix (rightmost tie), align.cc:400-456.
  void trim_back(const RCfg &cfg) {
    int64_t n = span();
    auto sc = column_scores(cfg, true);
    std::vector<int64_t> cum(n);
    int64_t acc = 0, gm = -1;
    for (int64_t i = 0; i < n; i++) {
      acc += sc[i];
      cum[i] = acc;
    }
    if (n) gm = *std::max_element(cum.begin(), cum.end());
    if (n == 0 || gm < 0) {
      a.clear();
      b.clear();
      ea = sa;
      eb = sb;
      cig.clear();
      populate();
      return;
    }
    int64_t max_i = -1;
    for (int64_t i = n - 1; i >= 0; i--)
      if (cum[i] == gm) {
        max_i = i;
        break;
      }
    max_i += 1;
    ea = sa;
    eb = sb;
    int64_t cur_len = 0;
    size_t ci = 0;
    while (ci < cig.size()) {
      char op = cig[ci].op;
      int64_t ln = cig[ci].len;
      if (ln + cur_len >= max_i) {
        if (op != 'M') throw Bail{};
        int64_t need = max_i - cur_len;
        cig[ci].len = need;
        cig.resize(ci + 1);
        ea += need;
        eb += need;
        break;
      }
      cur_len += ln;
      if (op == 'M') {
        ea += ln;
        eb += ln;
      } else if (op == 'I') {
        eb += ln;
      } else {
        ea += ln;
      }
      ci++;
    }
    if (ea - sa < 0 || ea - sa > (int64_t)a.size() || eb - sb < 0 ||
        eb - sb > (int64_t)b.size())
      throw Bail{};
    a.resize((size_t)(ea - sa));
    b.resize((size_t)(eb - sb));
    populate();
  }

  // merge() support: drop gapped-string suffix past the trim-th keyed
  // non-gap column from the END (align.cc:511-525 scan; ops/cigar.py
  // merge.cut_self)
  void cut_back(int64_t trim, bool key_a) {
    int64_t n = span(), pos, q = 0, r = 0;
    if (trim > 0) {
      int64_t count = 0;
      pos = 0;
      for (int64_t i = n - 1; i >= 0; i--) {
        char c = key_a ? ga[i] : gb[i];
        if (c != '-' && ++count == trim) {
          pos = i;
          break;
        }
      }
      for (int64_t i = pos; i < n; i++) {
        q += ga[i] != '-';
        r += gb[i] != '-';
      }
    } else {
      pos = n;
    }
    ga.resize(pos);
    mid.resize(pos);
    gb.resize(pos);
    ea = sa + (int64_t)a.size() - q;
    eb = sb + (int64_t)b.size() - r;
    a.resize(a.size() - (size_t)q);
    b.resize(b.size() - (size_t)r);
  }

  // ... and the prefix version (ops/cigar.py merge.cut_cur)
  void cut_front(int64_t trim, bool key_a) {
    int64_t n = span(), pos, q = 0, r = 0;
    if (trim > 0) {
      int64_t count = 0;
      pos = n;
      for (int64_t i = 0; i < n; i++) {
        char c = key_a ? ga[i] : gb[i];
        if (c != '-' && ++count == trim) {
          pos = i + 1;
          break;
        }
      }
      for (int64_t i = 0; i < pos; i++) {
        q += ga[i] != '-';
        r += gb[i] != '-';
      }
    } else {
      pos = 0;
    }
    ga.erase(0, (size_t)pos);
    mid.erase(0, (size_t)pos);
    gb.erase(0, (size_t)pos);
    sa += q;
    sb += r;
    a.erase(0, (size_t)q);
    b.erase(0, (size_t)r);
  }

  // align.cc:505-610 — merge an overlapping later alignment into this one
  void merge(Aln &cur, const uint8_t *qstr, const uint8_t *rstr,
             const RCfg &cfg) {
    if (!(cur.sa < ea || cur.sb < eb)) throw Bail{};
    if (!(ea <= cur.ea && eb <= cur.eb)) throw Bail{};
    int64_t trim = ea - cur.sa;
    cut_back(trim, true);
    cur.cut_front(trim, true);
    trim = eb - cur.sb;
    cut_back(trim, false);
    cur.cut_front(trim, false);
    cigar_from_alignment();
    cur.cigar_from_alignment();
    if (!(sa <= cur.sa && sb <= cur.sb)) throw Bail{};
    if (!(ea <= cur.sa && eb <= cur.sb)) throw Bail{};
    append_cigar(gap_cigar(qstr, rstr, ea, cur.sa, eb, cur.sb, cfg));
    int64_t qgap = cur.sa - ea, rgap = cur.sb - eb;
    a.append((const char *)qstr + ea, (size_t)qgap);
    a += cur.a;
    b.append((const char *)rstr + eb, (size_t)rgap);
    b += cur.b;
    ea = cur.ea;
    eb = cur.eb;
    append_cigar(cur.cig);
    populate();
  }
};

static Aln aln_from_seqs(const uint8_t *q, int64_t ql, const uint8_t *t,
                         int64_t tl, const RCfg &cfg) {
  Aln al;
  al.a.assign((const char *)q, (size_t)ql);
  al.b.assign((const char *)t, (size_t)tl);
  al.ea = ql;
  al.eb = tl;
  al.cig = run_dp(q, ql, t, tl, cfg);
  al.populate();
  return al;
}

// Stitch exact-match anchors with aligned gaps (align.cc:199-270;
// ops/cigar.py from_anchors_many per-chain body).
static Aln aln_from_anchors(const uint8_t *q, const uint8_t *r,
                            const std::vector<std::array<int64_t, 3>> &anc,
                            const RCfg &cfg) {
  Aln al;
  if (anc.empty()) return al;
  int64_t q0 = anc[0][0], r0 = anc[0][1], l0 = anc[0][2];
  al.sa = q0;
  al.ea = q0 + l0;
  al.sb = r0;
  al.eb = r0 + l0;
  al.a.assign((const char *)q + q0, (size_t)l0);
  al.b.assign((const char *)r + r0, (size_t)l0);
  al.cig = {{'M', l0}};
  int64_t pq = q0, pr = r0, pl = l0;
  for (size_t i = 1; i < anc.size(); i++) {
    int64_t aq = anc[i][0], ar = anc[i][1], ln = anc[i][2];
    int64_t qpe = pq + pl, rpe = pr + pl;
    if (!(qpe <= aq && rpe <= ar)) throw Bail{};
    auto gc = gap_cigar(q, r, qpe, aq, rpe, ar, cfg);
    al.ea = aq + ln;
    al.eb = ar + ln;
    al.a.append((const char *)q + qpe, (size_t)(aq + ln - qpe));
    al.b.append((const char *)r + rpe, (size_t)(ar + ln - rpe));
    al.append_cigar(gc);
    al.append_cigar({{'M', ln}});
    pq = aq;
    pr = ar;
    pl = ln;
  }
  al.populate();
  return al;
}

// Join sub-alignments with aligned gaps plus trimmed side extensions
// (align.cc:107-197; ops/cigar.py from_guide).
static Aln aln_from_guide(const uint8_t *q, int64_t qlen, const uint8_t *r,
                          int64_t rlen, const std::vector<Aln *> &guide,
                          int side, const RCfg &cfg) {
  Aln al = *guide[0];
  for (size_t gi = 1; gi < guide.size(); gi++) {
    Aln &cur = *guide[gi];
    if (!(al.ea <= cur.sa && al.eb <= cur.sb)) throw Bail{};
    auto gc = gap_cigar(q, r, al.ea, cur.sa, al.eb, cur.sb, cfg);
    int64_t qpe = al.ea, rpe = al.eb;
    al.ea = cur.ea;
    al.eb = cur.eb;
    al.a.append((const char *)q + qpe, (size_t)(cur.ea - qpe));
    al.b.append((const char *)r + rpe, (size_t)(cur.eb - rpe));
    al.append_cigar(gc);
    al.append_cigar(cur.cig);
  }
  int64_t qlo = al.sa, qhi = al.ea, rlo = al.sb, rhi = al.eb;
  if (side) {
    int64_t qlo_n = std::max<int64_t>(0, qlo - side);
    int64_t rlo_n = std::max<int64_t>(0, rlo - side);
    if ((qlo - qlo_n) && (rlo - rlo_n)) {
      Aln gap = aln_from_seqs(q + qlo_n, qlo - qlo_n, r + rlo_n,
                              rlo - rlo_n, cfg);
      gap.trim_front(cfg);
      qlo_n = qlo - (gap.ea - gap.sa);
      rlo_n = rlo - (gap.eb - gap.sb);
      al.prepend_cigar(gap.cig);
      al.a.insert(0, (const char *)q + qlo_n, (size_t)(qlo - qlo_n));
      al.b.insert(0, (const char *)r + rlo_n, (size_t)(rlo - rlo_n));
      al.sa = qlo = qlo_n;
      al.sb = rlo = rlo_n;
    }
    int64_t qhi_n = std::min(qhi + side, qlen);
    int64_t rhi_n = std::min(rhi + side, rlen);
    if ((qhi_n - qhi) && (rhi_n - rhi)) {
      Aln gap = aln_from_seqs(q + qhi, qhi_n - qhi, r + rhi, rhi_n - rhi,
                              cfg);
      gap.trim_back(cfg);
      qhi_n = qhi + gap.ea;
      rhi_n = rhi + gap.eb;
      al.append_cigar(gap.cig);
      al.a.append((const char *)q + qhi, (size_t)(qhi_n - qhi));
      al.b.append((const char *)r + rhi, (size_t)(rhi_n - rhi));
      al.ea = qhi = qhi_n;
      al.eb = rhi = rhi_n;
    }
  }
  al.populate();
  return al;
}

struct RHit {
  int64_t qs, qe, rs, re;
  Aln aln;
};

// refine.cc:23-193 (models/aligner.py refine_chains)
static void refine_chains(std::vector<RHit> &hits, const uint8_t *q,
                          int64_t qlen, const uint8_t *r, int64_t rlen,
                          bool same_chr, int64_t oqs, int64_t ors,
                          const RCfg &cfg, std::vector<RHit> &out) {
  std::stable_sort(hits.begin(), hits.end(),
                   [](const RHit &x, const RHit &y) {
                     return std::tie(x.qs, x.qe, x.rs, x.re) <
                            std::tie(y.qs, y.qe, y.rs, y.re);
                   });
  int64_t n = (int64_t)hits.size();
  std::vector<int64_t> score(n), dp(n, 0);
  std::vector<int64_t> prev(n, -1);
  for (int64_t i = 0; i < n; i++)
    score[i] = (int64_t)(cfg.rf_match * (double)hits[i].aln.matches -
                         cfg.rf_mismatch * (double)hits[i].aln.mismatches -
                         cfg.rf_gap * (double)hits[i].aln.gap_bases());
  std::vector<std::pair<int64_t, int64_t>> maxes;
  for (int64_t ai = 0; ai < n; ai++) {
    const RHit &c = hits[ai];
    if (same_chr) {
      int64_t qo = std::max<int64_t>(
          0, std::min(oqs + c.qe, ors + c.re) -
                 std::max(oqs + c.qs, ors + c.rs));
      if ((c.re - c.rs) - qo < cfg.rf_side_align &&
          (c.qe - c.qs) - qo < cfg.rf_side_align)
        continue;
    }
    dp[ai] = score[ai];
    for (int64_t aj = ai - 1; aj >= 0; aj--) {
      const RHit &p = hits[aj];
      int64_t cqs = std::max(c.qs, p.qe);
      int64_t crs = std::max(c.rs, p.re);
      if (p.qe >= c.qe || p.re >= c.re) continue;
      if (p.rs >= c.rs) continue;
      int64_t ma = std::max(cqs - p.qe, crs - p.re);
      int64_t mi = std::min(cqs - p.qe, crs - p.re);
      if (ma >= cfg.rf_max_gap) continue;
      if (same_chr) {
        int64_t qo = std::max<int64_t>(
            0, std::min(oqs + cqs, ors + crs) -
                   std::max(oqs + p.qe, ors + p.re));
        if (qo >= 1) continue;
      }
      int64_t mis = (int64_t)(cfg.rf_mismatch * (double)mi);
      int64_t gap = (int64_t)(cfg.rf_gapopen + cfg.rf_gap * (double)(ma - mi));
      int64_t sco = dp[aj] + score[ai] - mis - gap;
      if (sco >= dp[ai]) {
        dp[ai] = sco;
        prev[ai] = aj;
      }
    }
    maxes.push_back({dp[ai], ai});
  }

  std::sort(maxes.begin(), maxes.end(),
            std::greater<std::pair<int64_t, int64_t>>());
  std::vector<char> used(n, 0);
  for (auto &m : maxes) {
    if (m.first == 0) break;
    int64_t maxi = m.second;
    if (used[maxi]) continue;
    std::vector<int64_t> path;
    while (maxi != -1 && !used[maxi]) {
      path.push_back(maxi);
      used[maxi] = 1;
      maxi = prev[maxi];
    }
    std::reverse(path.begin(), path.end());

    int64_t qlo = hits[path[0]].qs, qhi = hits[path.back()].qe;
    int64_t rlo = hits[path[0]].rs, rhi = hits[path.back()].re;

    int64_t est = hits[path[0]].aln.span();
    for (size_t i = 1; i < path.size(); i++) {
      est += hits[path[i]].aln.span();
      est += std::max(hits[path[i]].qs - hits[path[i - 1]].qe,
                      hits[path[i]].rs - hits[path[i - 1]].re);
    }
    if (est < cfg.rf_min_read - cfg.rf_side_align) continue;

    bool overlap = false;
    for (auto &h : out) {
      int64_t qo = std::max<int64_t>(
          0, std::min(qhi, h.qe) - std::max(qlo, h.qs));
      int64_t ro = std::max<int64_t>(
          0, std::min(rhi, h.re) - std::max(rlo, h.rs));
      if (qhi - qlo - qo < cfg.rf_side_align &&
          rhi - rlo - ro < cfg.rf_side_align) {
        overlap = true;
        break;
      }
    }
    if (overlap) continue;

    std::vector<Aln *> guide;
    RHit *prevh = &hits[path[0]];
    for (size_t pi = 1; pi < path.size(); pi++) {
      RHit *cur = &hits[path[pi]];
      if (cur->qs < prevh->qe || cur->rs < prevh->re) {
        prevh->aln.merge(cur->aln, q, r, cfg);
        prevh->qs = prevh->aln.sa;
        prevh->qe = prevh->aln.ea;
        prevh->rs = prevh->aln.sb;
        prevh->re = prevh->aln.eb;
      } else {
        guide.push_back(&prevh->aln);
        prevh = cur;
      }
    }
    guide.push_back(&prevh->aln);

    RHit hit;
    hit.aln = aln_from_guide(q, qlen, r, rlen, guide, cfg.rf_side_align,
                             cfg);
    hit.qs = hit.aln.sa;
    hit.qe = hit.aln.ea;
    hit.rs = hit.aln.sb;
    hit.re = hit.aln.eb;
    if (hit.aln.span() >= cfg.rf_min_read) out.push_back(std::move(hit));
  }
}

// chain.cc:203-268 (models/aligner.py fast_align)
static void fast_align_impl(const uint8_t *q, int64_t qlen,
                            const uint8_t *r, int64_t rlen, bool same_chr,
                            int64_t oqs, int64_t ors, const RCfg &cfg,
                            std::vector<RHit> &out) {
  std::vector<int32_t> abuf;
  int64_t cap = 4 * std::max<int64_t>(1 << 12, qlen / 4);
  int64_t na;
  for (;;) {
    abuf.resize((size_t)cap);
    na = sedef_anchors(q, qlen, r, rlen, same_chr ? 1 : 0, oqs, ors, cfg.k,
                       1000, abuf.data(), cap);
    if (na >= 0) break;
    if (na == -2) throw Bail{};
    cap = std::max(cap * 4, (-na - 1) * 16 + 64);
  }

  std::vector<int32_t> aq(na), ar(na), al_(na), ahu(na);
  for (int64_t i = 0; i < na; i++) {
    aq[i] = abuf[4 * i];
    ar[i] = abuf[4 * i + 1];
    al_[i] = abuf[4 * i + 2];
    ahu[i] = abuf[4 * i + 3];
  }
  std::vector<int32_t> path((size_t)std::max<int64_t>(na, 1));
  int64_t bcap = 2 * (na + 2);
  std::vector<int64_t> bounds((size_t)bcap);
  int64_t nb = sedef_chain(aq.data(), ar.data(), al_.data(), ahu.data(), na,
                           cfg.max_chain_gap, cfg.match_chain_score,
                           path.data(), bounds.data(), bcap);
  if (nb < 0) throw Bail{};

  std::vector<RHit> hits;
  std::vector<std::vector<std::array<int64_t, 3>>> guides;
  for (int64_t bi = 1; bi < nb; bi++) {
    int64_t be = bounds[2 * bi], hu = bounds[2 * bi + 1];
    int64_t bs = bounds[2 * (bi - 1)];
    int64_t qlo = aq[path[be - 1]];
    int64_t qhi = (int64_t)aq[path[bs]] + al_[path[bs]];
    int64_t rlo = ar[path[be - 1]];
    int64_t rhi = (int64_t)ar[path[bs]] + al_[path[bs]];
    int64_t span = std::max(rhi - rlo, qhi - qlo);
    if ((hu == 0 || span < cfg.min_uppercase_match) &&
        (double)span <
            (double)cfg.min_read_size * (1.0 - cfg.max_error))
      continue;
    RHit h;
    h.qs = qlo;
    h.qe = qhi;
    h.rs = rlo;
    h.re = rhi;
    hits.push_back(std::move(h));
    std::vector<std::array<int64_t, 3>> g;
    for (int64_t i = be - 1; i >= bs; i--)
      g.push_back({(int64_t)aq[path[i]], (int64_t)ar[path[i]],
                   (int64_t)al_[path[i]]});
    guides.push_back(std::move(g));
  }
  for (size_t i = 0; i < hits.size(); i++) {
    hits[i].aln = aln_from_anchors(q, r, guides[i], cfg);
    hits[i].qs = hits[i].aln.sa;
    hits[i].qe = hits[i].aln.ea;
    hits[i].rs = hits[i].aln.sb;
    hits[i].re = hits[i].aln.eb;
  }
  refine_chains(hits, q, qlen, r, rlen, same_chr, oqs, ors, cfg, out);
}

}  // namespace region_align

extern "C" {

// Full-region fast_align + refine.  Per-hit output: 8 int64 fields
// (qs, qe, rs, re, n_cigar_runs, matches, mismatches, gap_bases); CIGAR
// runs concatenated into ops_out/lens_out in hit order.  Returns n_hits,
// -1 = fall back to the Python path, -2 = hit_out too small (regrow),
// -3 = cigar buffers too small (regrow).
int64_t sedef_fast_align(
    const uint8_t *q, int64_t qlen, const uint8_t *r, int64_t rlen,
    int same_chr, int64_t oqs, int64_t ors, int k, int match, int mis,
    int gapo, int gape, int max_chain_gap, int match_chain_score,
    int min_uppercase_match, int min_read_size, double max_error,
    double rf_match, double rf_mismatch, double rf_gap, double rf_gapopen,
    int rf_min_read, int rf_side_align, int rf_max_gap, int64_t *hit_out,
    int64_t hit_cap, uint8_t *ops_out, int32_t *lens_out,
    int64_t cig_cap) {
  using namespace region_align;
  RCfg cfg;
  cfg.match = match;
  cfg.mis = mis;
  cfg.gapo = gapo;
  cfg.gape = gape;
  cfg.k = k;
  cfg.max_chain_gap = max_chain_gap;
  cfg.match_chain_score = match_chain_score;
  cfg.min_uppercase_match = min_uppercase_match;
  cfg.min_read_size = min_read_size;
  cfg.max_error = max_error;
  cfg.rf_match = rf_match;
  cfg.rf_mismatch = rf_mismatch;
  cfg.rf_gap = rf_gap;
  cfg.rf_gapopen = rf_gapopen;
  cfg.rf_min_read = rf_min_read;
  cfg.rf_side_align = rf_side_align;
  cfg.rf_max_gap = rf_max_gap;

  std::vector<RHit> out;
  try {
    fast_align_impl(q, qlen, r, rlen, same_chr != 0, oqs, ors, cfg, out);
  } catch (Bail &) {
    return -1;
  } catch (std::exception &) {
    return -1;
  }

  int64_t nh = (int64_t)out.size();
  if (nh * 8 > hit_cap) return -2;
  int64_t cpos = 0;
  for (int64_t i = 0; i < nh; i++) {
    RHit &h = out[i];
    int64_t ncig = (int64_t)h.aln.cig.size(), gb = 0;
    if (cpos + ncig > cig_cap) return -3;
    for (auto &c : h.aln.cig) {
      ops_out[cpos] = (uint8_t)c.op;
      lens_out[cpos] = (int32_t)c.len;
      if (c.op != 'M') gb += c.len;
      cpos++;
    }
    int64_t *row = hit_out + i * 8;
    row[0] = h.qs;
    row[1] = h.qe;
    row[2] = h.rs;
    row[3] = h.re;
    row[4] = ncig;
    row[5] = h.aln.matches;
    row[6] = h.aln.mismatches;
    row[7] = gb;
  }
  return nh;
}

}  // extern "C"
