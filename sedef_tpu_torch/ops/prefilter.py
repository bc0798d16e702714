"""Counterpart of ``sedef_tpu/ops/prefilter.py``.

Recompute-wide device prefilter for the stage-1 roll (SURVEY §7.1).

The reference's hottest loop (``src/search.cc:289-315``) rolls a ~700 bp
reference window 1 bp at a time over each candidate interval, maintaining
the incremental path-dependent sketch of ``src/sliding.cc``.  Instead of
replaying that op stream, this module *bounds* it, batched over every
planned interval at once, and proves most intervals cannot pass the
Jaccard gate without any sequential work at all.

Soundness (why a bound suffices for byte-identical output):

* The sliding map's ``add`` (sliding.cc:69-93) counts a new shared
  element only when it lands STRICTLY below the boundary iterator
  (``it->first < boundary->first``, sliding.cc:86); an element landing
  exactly ON the boundary — inside the sketch window — is silently not
  counted.  Every other update (``remove``'s ``<=`` test, the boundary
  steps on insert/erase, the query-side adds) applies the exact delta of
  the *ideal* sketch intersection — the number of shared keys among the
  |Q| smallest elements of the union W(A) ∪ W(B), boundary inclusive.
  The counter's deviation from ideal is therefore a sum of missed
  increments only:

      intersection(step) <= ideal(window composition at that step)

  for every step of every op stream.
* Every window the roll evaluates is a loci-window of length
  ``init_len``; its composition (the set of reference minimizers inside)
  changes only when the window boundary crosses a minimizer locus, so
  the distinct compositions of an interval's roll are exactly the
  windows starting at ``t0`` or at ``locs[i]+1`` / ``locs[i]-L+1``
  (clamped to ``[t0, t0+n_steps]``) for span minimizers ``i`` —
  ~``2*span+1`` candidate offsets.  If

      max over those compositions of ideal < limit

  (the sketch's relaxed Jaccard cutoff — fixed during the roll because
  the query side never changes), the roll provably ends with
  ``jaccard() < 0``: the interval takes the JACCARD_FAILED branch with
  no hit and no tree update, so skipping it is byte-identical (native
  sedef_search's ``dev[0] < 0`` path still bumps the total/jaccard
  funnel counters).

Each composition is one independent row — gather its <= RW window keys,
sort, and merge-rank against the window's sorted query sketch (the
``ideal`` count, computed by :func:`merge_rank_intersection`) — up to
``ROW_BATCH`` rows a dispatch with no sequential dependence.  The host
rolls only the surviving intervals.  tests/test_torch_prefilter.py
re-verifies the bound against the scalar SlidingJaccard oracle.

The device work is queued on the current stream of the device the keys
live on; ``PendingPrefilter.collect()`` is where the host first waits for
it.  A device error raises: no interval silently goes to the host.  On a
card both row evaluations (phase A's span rows, phase B's composition
rows) are launches of one kernel, ``csrc/window_ideals.cu``, which sorts
each row in shared memory and never builds the plain versions' (rows,
SQ + width) concat; the query sketches are one launch of
``csrc/window_sketches.cu`` (a warp a row, the dedup a ballot compaction).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .jaccard_batch import merge_rank_intersection
from .wavefront import _check, _kernels, _launch, _ptr, _same_device

INF32 = 2**31 - 1

DEFAULT_SQ = 160   # max distinct query-window keys
DEFAULT_RW = 192   # max minimizers inside one init_len window
DEFAULT_SA = 1024  # max minimizers inside one interval SPAN (phase A)
# rows a dispatch, a memory bound: phase B's composition rows, and phase
# A's span rows (1,184 keys wide against 352, so fewer of them)
ROW_BATCH = 131072
SPAN_BATCH = 32768

# what the last collected prefilters did, summed until reset (read by
# chip_smoke.py): intervals, pruned in phase A and in phase B, composition
# rows, and the device ms from dispatch to collect (CUDA events)
STATS = dict(intervals=0, pruned_a=0, pruned_b=0, rows=0, device_ms=0.0)
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    with _STATS_LOCK:
        for key in STATS:
            STATS[key] = 0.0 if key == "device_ms" else 0


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None, :]


def _gather(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """keys[min(idx, n - 1)] (the caller masks the clamped lanes)."""
    return keys[torch.clamp(idx, max=keys.shape[0] - 1).long()]


def _window_sketches_torch(q_keys, qws, qwe, limit_lut, SQ: int):
    """``_window_sketches``' plain version.  Per-interval sorted distinct
    query-window keys + relaxed limit.

    Returns (qk (B, SQ) int32 INF-padded ascending, s (B,) int32, limit
    (B,) int32, ovf (B,) bool)."""
    B = qws.shape[0]
    gq = qws[:, None] + _iota(SQ, qws.device)
    valq = gq < qwe[:, None]
    qk = torch.where(valq, _gather(q_keys, gq), INF32)
    qk = torch.sort(qk, dim=1).values
    dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=qk.device),
                     qk[:, 1:] == qk[:, :-1]], dim=1)
    qk = torch.sort(torch.where(dup, INF32, qk), dim=1).values
    s = (qk != INF32).sum(dim=1, dtype=torch.int32)
    limit = limit_lut[torch.clamp(s, max=limit_lut.shape[0] - 1).long()]
    return qk, s, limit, (qwe - qws) > SQ


def _window_sketches(q_keys, qws, qwe, limit_lut, SQ: int):
    """The per-interval query sketches, as ``_window_sketches_torch``: on
    CUDA tensors one launch of ``csrc/window_sketches.cu`` on the current
    stream (no synchronisation), on CPU tensors the plain version."""
    dev = _same_device(q_keys, qws, qwe, limit_lut)
    if dev.type == "cpu":
        return _window_sketches_torch(q_keys, qws, qwe, limit_lut, SQ)
    for name, t in (("q_keys", q_keys), ("qws", qws), ("qwe", qwe),
                    ("limit_lut", limit_lut)):
        _check(t, torch.int32, 1, name)
    B = qws.shape[0]
    if qwe.shape[0] != B:
        raise ValueError("qws and qwe must have one length")
    if q_keys.shape[0] < 1 or limit_lut.shape[0] < 1:
        raise ValueError("empty query keys or limit table")
    if not 1 <= SQ <= 1024:
        raise ValueError(f"SQ {SQ} is not in [1, 1024]")
    qk = torch.empty((B, SQ), dtype=torch.int32, device=dev)
    s = torch.empty(B, dtype=torch.int32, device=dev)
    limit = torch.empty(B, dtype=torch.int32, device=dev)
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        _launch(KERNEL_WRAPPERS[2], dev, _kernels().sedef_window_sketches,
                q_keys.data_ptr(), qws.data_ptr(), qwe.data_ptr(),
                limit_lut.data_ptr(), qk.data_ptr(), s.data_ptr(),
                limit.data_ptr(), ovf.data_ptr(), B, q_keys.shape[0],
                limit_lut.shape[0], SQ)
    return qk, s, limit, ovf


def _window_keys(r_keys, a, b, width: int, n_shift: int):
    """(N, width) int32: each row's ref keys [a, b) in locus order, HAS_N
    keys and the lanes past b as INF, sorted ascending."""
    gi = a[:, None] + _iota(width, a.device)
    keys_w = torch.where(gi < b[:, None], _gather(r_keys, gi), INF32)
    # HAS_N ref keys are never added to the sketch (sliding.cc:158-168)
    keys_w = torch.where((keys_w >> n_shift) == 2, INF32, keys_w)
    return torch.sort(keys_w, dim=1).values


def _span_intersections_torch(r_keys, qk_all, sa, sb, SA: int,
                              n_shift: int):
    """``_span_intersections``'s plain version.  Phase A: plain
    distinct-intersection bound per interval.

    For any window W inside an interval's span, ideal(Q, R_W) <=
    |Q ∩ R_W| <= |Q ∩ R_span| — so one row per INTERVAL (vs one per
    window composition) proves most fail-heavy intervals dead before any
    composition row is built.  sa/sb (B,) int32: the span's [sa, sb)
    minimizer range (host-computed).  Rows align 1:1 with qk_all.  Returns
    (B,) int32 |Q ∩ R_span|, INF32 where the span overflowed SA (no
    bound)."""
    keys_w = _window_keys(r_keys, sa, sb, SA, n_shift)
    # rank condition disabled (s = row width): plain intersection count
    full = torch.full(sa.shape, qk_all.shape[1] + SA, dtype=torch.int32,
                      device=sa.device)
    inter = merge_rank_intersection(qk_all, keys_w, full)
    return torch.where((sb - sa) > SA, INF32, inter)


def _composition_ideals_torch(r_keys, qk_all, s_all, a, b, iv_id,
                              RW: int, n_shift: int):
    """``_composition_ideals``'s plain version.  Ideal sketch intersection
    for one batch of composition rows.

    a/b (N,) int32: each window's [a, b) minimizer range in locus order
    (computed on the host); iv_id (N,) int32 interval index into
    qk_all/s_all.  Returns (N,) int32 ideal counts, or INF32 where the
    window overflowed RW (no bound for that row)."""
    keys_w = _window_keys(r_keys, a, b, RW, n_shift)
    iv = iv_id.long()
    # ideal = |{k in Q ∩ R : rank_union(k) < s}|; duplicate window keys
    # collapse inside the reduction, so no separate dedup pass is needed
    ideal = merge_rank_intersection(qk_all[iv], keys_w, s_all[iv])
    return torch.where((b - a) > RW, INF32, ideal)


def _window_ideals(wrapper, r_keys, qk_all, s_all, a, b, iv_id,
                   width: int, s_const: int, n_shift: int):
    """One launch of ``csrc/window_ideals.cu`` on the current stream (no
    synchronisation), counted on ``wrapper``: per row, the shared keys of
    rank < s between the ref keys [a, b) (HAS_N dropped) and its query
    row (row iv_id, or the row's own where iv_id is None; s from s_all, or
    ``s_const`` where s_all is None); INF32 where b - a > width."""
    named = [("r_keys", r_keys, 1), ("qk_all", qk_all, 2), ("a", a, 1),
             ("b", b, 1), ("s_all", s_all, 1), ("iv_id", iv_id, 1)]
    for name, t, nd in named:
        if t is not None:
            _check(t, torch.int32, nd, name)
    dev = _same_device(*[t for _, t, _ in named if t is not None])
    N = a.shape[0]
    if b.shape[0] != N or (iv_id is not None and iv_id.shape[0] != N):
        raise ValueError("a, b and iv_id must have one length")
    if iv_id is None and qk_all.shape[0] != N:
        raise ValueError("rows must align with qk_all")
    if r_keys.shape[0] < 1 or qk_all.shape[1] < 1:
        raise ValueError("empty ref keys or query rows")
    if not 1 <= width <= 4096:
        raise ValueError(f"width {width} is not in [1, 4096]")
    out = torch.empty(N, dtype=torch.int32, device=dev)
    if N:
        _launch(wrapper, dev, _kernels().sedef_window_ideals,
                r_keys.data_ptr(), qk_all.data_ptr(), _ptr(s_all),
                a.data_ptr(), b.data_ptr(), _ptr(iv_id), out.data_ptr(), N,
                r_keys.shape[0], qk_all.shape[1], width, s_const, n_shift)
    return out


def _span_intersections(r_keys, qk_all, sa, sb, SA: int, n_shift: int):
    """Phase A's span bounds, as ``_span_intersections_torch``: on CUDA
    tensors one launch of ``csrc/window_ideals.cu`` (a block a row), on CPU
    tensors the plain version."""
    dev = _same_device(r_keys, qk_all, sa, sb)
    if dev.type == "cpu":
        return _span_intersections_torch(r_keys, qk_all, sa, sb, SA,
                                         n_shift)
    # rank condition disabled (s = the row width): plain intersection
    return _window_ideals(KERNEL_WRAPPERS[0], r_keys, qk_all, None, sa, sb,
                          None, SA, qk_all.shape[1] + SA, n_shift)


def _composition_ideals(r_keys, qk_all, s_all, a, b, iv_id,
                        RW: int, n_shift: int):
    """Phase B's composition ideals, as ``_composition_ideals_torch``: on
    CUDA tensors one launch of ``csrc/window_ideals.cu`` (a warp a row), on
    CPU tensors the plain version."""
    dev = _same_device(r_keys, qk_all, s_all, a, b, iv_id)
    if dev.type == "cpu":
        return _composition_ideals_torch(r_keys, qk_all, s_all, a, b,
                                         iv_id, RW, n_shift)
    return _window_ideals(KERNEL_WRAPPERS[1], r_keys, qk_all, s_all, a, b,
                          iv_id, RW, 0, n_shift)


# the wrappers that launch this module's kernels, with their launch counts;
# counted through this tuple, so that a caller that wraps the module's
# functions (chip_smoke.py's op timer) leaves the counts alone
KERNEL_WRAPPERS = (_span_intersections, _composition_ideals,
                   _window_sketches)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def _ragged_arange(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """concatenate([arange(s, s+c) for s, c in zip(starts, counts)])."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    off = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return (np.arange(total, dtype=np.int64)
            - np.repeat(off, counts) + np.repeat(starts, counts))


def _upload(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


class PendingPrefilter:
    """In-flight prefilter verdicts: phase A is queued on the device and
    ``collect()`` blocks on the results.  Keeping dispatch and collect
    separate lets the pipeline queue one chromosome pair's device work
    while it plans or searches the next (models/pipeline.py search_job's
    two-phase loop)."""

    def __init__(self, pf, n, bj, bs, ok, ctx):
        self._pf = pf
        self._n = n
        self._bj, self._bs, self._ok = bj, bs, ok
        self._ctx = ctx

    def collect(self):
        """Block on the device results; returns (best_j, best_steps, ok).

        Phase A (one span-bound row per interval) is pulled first;
        composition rows (phase B) are built and dispatched ONLY for the
        phase-A survivors — the device time grows with the rows, and on
        fail-heavy workloads phase A kills most of them."""
        n = self._n
        if n == 0 or self._ctx is None:
            return self._bj, self._bs, self._ok
        ctx = self._ctx
        self._ctx = None

        span_i = ctx["span_i"].cpu().numpy().astype(np.int64)
        limit = ctx["limit"].cpu().numpy().astype(np.int64)
        s_all = ctx["s_all"].cpu().numpy()
        qovf = ctx["qovf"].cpu().numpy()
        eligible = (~qovf) & (s_all > 0)
        verdict = eligible & (span_i < limit)
        pruned_a = int(verdict.sum())

        survivors = np.nonzero(eligible & ~verdict)[0].astype(np.int64)
        rows = 0
        if len(survivors):
            pending, row_iv = self._pf._dispatch_compositions(ctx,
                                                              survivors)
            rows = len(row_iv)
            ideal_max = np.zeros(n, np.int64)
            for part, out in pending:
                np.maximum.at(ideal_max, row_iv[part],
                              out.cpu().numpy().astype(np.int64))
            verdict[survivors] |= ideal_max[survivors] < limit[survivors]
        self._bj[verdict] = -1
        self._ok[:] = verdict
        ms = 0.0
        if ctx["start"] is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            ms = ctx["start"].elapsed_time(end)
        with _STATS_LOCK:
            STATS["intervals"] += n
            STATS["pruned_a"] += pruned_a
            STATS["pruned_b"] += int(verdict.sum()) - pruned_a
            STATS["rows"] += rows
            STATS["device_ms"] += ms
        return self._bj, self._bs, self._ok


class RollPrefilter:
    """Batches planned intervals into composition rows and returns
    per-interval verdicts in the native ``sedef_search`` results contract:
    (best_j=-1, best_steps=0, ok=True) where the roll provably fails the
    Jaccard gate; ok=False (host rolls) everywhere else."""

    def __init__(self, kmer_size: int, limit_lut: np.ndarray,
                 init_len: int, SQ: int = DEFAULT_SQ, RW: int = DEFAULT_RW,
                 SA: int = DEFAULT_SA, device="cuda"):
        if kmer_size > 14:
            raise ValueError("packed int32 keys need 2k+2 <= 30 (k <= 14)")
        self.n_shift = 2 * kmer_size
        self.device = torch.device(device)
        self.limit_lut = _upload(limit_lut, self.device)
        self.L = int(init_len)
        self.SQ = SQ
        self.RW = RW
        self.SA = SA

    def run(self, q_keys, r_keys, r_locs_host: np.ndarray, qws, qwe, t0,
            rws0, n_steps):
        """Verdicts for all planned intervals (plan order) — dispatch +
        blocking collect."""
        return self.dispatch(q_keys, r_keys, r_locs_host, qws, qwe, t0,
                             rws0, n_steps).collect()

    def dispatch(self, q_keys, r_keys, r_locs_host: np.ndarray, qws, qwe,
                 t0, rws0, n_steps) -> PendingPrefilter:
        """Queue phase A for all planned intervals (plan order) without
        blocking; the returned handle's ``collect()`` yields the verdicts.

        q_keys / r_keys: int32 minimizer keys on the prefilter's device;
        r_locs_host: the ref's host loci (event construction);
        qws/qwe: per-interval query window minimizer range;
        t0/rws0/n_steps: plan interval columns."""
        n = len(qws)
        bj = np.zeros(n, np.int32)
        bs = np.zeros(n, np.int32)
        ok = np.zeros(n, bool)
        if n == 0:
            return PendingPrefilter(self, 0, bj, bs, ok, None)
        dev = self.device
        start = None
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = np.asarray(t0, np.int64)
        rws0 = np.asarray(rws0, np.int64)
        n_steps = np.asarray(n_steps, np.int64)

        # ---- per-interval query sketches ----
        qk_all, s_all, limit, qovf = _window_sketches(
            q_keys, _upload(qws, dev), _upload(qwe, dev), self.limit_lut,
            SQ=self.SQ)

        # ---- phase A: one span-bound row per interval ----
        # span [sa, sb) covers every window the roll can visit; rws0 IS
        # native find_minimizers(t0) — the identical left-searchsorted —
        # so reuse it as the span start rather than recomputing
        span_end = np.searchsorted(r_locs_host, t0 + n_steps + self.L,
                                   side="left").astype(np.int64)
        sa = _upload(rws0, dev)
        sb = _upload(span_end, dev)
        span_i = torch.cat([
            _span_intersections(r_keys, qk_all[i:i + SPAN_BATCH],
                                sa[i:i + SPAN_BATCH], sb[i:i + SPAN_BATCH],
                                SA=self.SA, n_shift=self.n_shift)
            for i in range(0, n, SPAN_BATCH)])

        ctx = dict(span_i=span_i, limit=limit, s_all=s_all, qovf=qovf,
                   qk_all=qk_all, r_keys=r_keys, r_locs_host=r_locs_host,
                   t0=t0, rws0=rws0, n_steps=n_steps, span_end=span_end,
                   start=start)
        return PendingPrefilter(self, n, bj, bs, ok, ctx)

    def _dispatch_compositions(self, ctx, survivors: np.ndarray):
        """Phase B: composition rows for the phase-A survivor intervals.

        Every distinct window the roll visits starts at t0 or at a
        (clamped) minimizer-boundary event; each becomes one row of the
        batched ideal evaluation.  Returns (pending, row_iv) for the
        collector: pending holds (row slice, (rows,) int32 device tensor)
        per batch of at most ``ROW_BATCH`` rows."""
        r_locs_host = ctx["r_locs_host"]
        t0, rws0 = ctx["t0"], ctx["rws0"]
        n_steps, span_end = ctx["n_steps"], ctx["span_end"]

        span_n = np.maximum(span_end - rws0, 0)[survivors]
        idx = _ragged_arange(rws0[survivors], span_n)
        ev_loc = r_locs_host[idx].astype(np.int64)
        row_iv1 = np.repeat(survivors.astype(np.int32), span_n)
        lo = t0[row_iv1]
        hi = t0[row_iv1] + n_steps[row_iv1]
        rs_events = np.concatenate([
            np.clip(ev_loc + 1, lo, hi),           # remove-boundary events
            np.clip(ev_loc - self.L + 1, lo, hi),  # add-boundary events
            t0[survivors],                         # the initial window
        ]).astype(np.int64)
        row_iv = np.concatenate([row_iv1, row_iv1,
                                 survivors.astype(np.int32)])

        # window [a, b) minimizer bounds on the host (np.searchsorted over
        # the loci)
        wa = np.searchsorted(r_locs_host, rs_events, side="left")
        wb = np.searchsorted(r_locs_host, rs_events + self.L, side="left")

        dev = self.device
        pending = []
        for off in range(0, len(rs_events), ROW_BATCH):
            part = slice(off, min(off + ROW_BATCH, len(rs_events)))
            out = _composition_ideals(
                ctx["r_keys"], ctx["qk_all"], ctx["s_all"],
                _upload(wa[part], dev), _upload(wb[part], dev),
                _upload(row_iv[part], dev), RW=self.RW,
                n_shift=self.n_shift)
            pending.append((part, out))
        return pending, row_iv
