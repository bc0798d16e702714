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
``ideal`` count, computed by :func:`merge_rank_intersection` in the plain
version) — with no sequential dependence.  The host rolls only the
surviving intervals.  tests/test_torch_prefilter.py
re-verifies the bound against the scalar SlidingJaccard oracle.

The device work is queued on the current stream of the device the keys
live on; ``PendingPrefilter.collect()`` is where the host first waits for
it.  A device error raises: no interval silently goes to the host.  On a
card a pair's dispatch is one upload of the plan's five columns, one
launch of ``csrc/prefilter_intervals.cu`` (an interval a block: its
sketch, phase A's span bound, phase B's windows enumerated and bounded
on the card) and one pull of an (n, 2) record; no event row, window
bound or ideal goes through the host.  Its plain version,
``_interval_verdicts_torch``, runs the three row functions below
(``_window_sketches_torch``, ``_span_intersections_torch``,
``_composition_ideals_torch``, the counterparts of the reference's three
jit programs) over rows built with torch ops; the kernel builds the
sketches and window rows with the row code of ``csrc/window_rows.cuh``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import trace
from ..native import kernels
from .jaccard_batch import merge_rank_intersection

INF32 = 2**31 - 1

DEFAULT_SQ = 160   # max distinct query-window keys
DEFAULT_RW = 192   # max minimizers inside one init_len window
DEFAULT_SA = 1024  # max minimizers inside one interval SPAN (phase A)
# rows a call of the plain version's row functions, a memory bound: phase
# B's composition rows, and phase A's span rows (1,184 keys wide against
# 352, so fewer of them)
ROW_BATCH = 131072
SPAN_BATCH = 32768
# loci of a span the per-interval kernel stages in shared memory at a time
INTERVAL_TILE = 1024

# what the collected prefilters did, summed until reset (read by
# chip_smoke.py and entry.py): intervals, pruned in phase A and in phase B,
# composition rows
STATS = trace.Counters("prefilter",
                       ("intervals", "pruned_a", "pruned_b", "rows"))


def reset_stats() -> None:
    STATS.reset()


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None, :]


def _gather(keys: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """keys[min(idx, n - 1)] (the caller masks the clamped lanes)."""
    return keys[torch.clamp(idx, max=keys.shape[0] - 1).long()]


def _window_sketches_torch(q_keys, qws, qwe, limit_lut, SQ: int):
    """Per-interval sorted distinct query-window keys + relaxed limit
    (the reference's ``_window_sketches``).

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
    """Phase A: plain distinct-intersection bound per interval (the
    reference's ``_span_intersections``).

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
    """Ideal sketch intersection for one batch of composition rows (the
    reference's ``_composition_ideals``).

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


def _composition_windows(locs, t0, t1, rws0, span_n, surv, L: int):
    """Phase B's windows of the intervals ``surv`` (int64 ids) in torch
    ops: for each span locus the remove window clip(loc + 1, t0, t1) and
    the add window clip(loc - L + 1, t0, t1), then each interval's window
    at t0 (locs int64 ascending; t0, t1 = t0 + n_steps int64; span_n
    int64).  Returns (row_iv int64, a int32, b int32): each window's
    interval and its [a, b) range of loci in [rs, rs + L), by
    ``torch.searchsorted``."""
    cnt = span_n[surv]
    iv1 = surv.repeat_interleave(cnt)
    first = torch.cumsum(cnt, 0, dtype=torch.int64) - cnt
    idx = (torch.arange(iv1.shape[0], dtype=torch.int64, device=locs.device)
           + (rws0.long()[surv] - first).repeat_interleave(cnt))
    loc = locs[idx]
    lo, hi = t0[iv1], t1[iv1]
    rs = torch.cat([torch.clamp(loc + 1, lo, hi),       # removes
                    torch.clamp(loc - L + 1, lo, hi),   # adds
                    t0[surv]])                          # the t0 window
    a = torch.searchsorted(locs, rs, side="left").int()
    b = torch.searchsorted(locs, rs + L, side="left").int()
    return torch.cat([iv1, iv1, surv]), a, b


def _interval_verdicts_torch(q_keys, r_keys, r_locs, limit_lut, plan,
                             L: int, SQ: int, RW: int, SA: int,
                             n_shift: int):
    """``_interval_verdicts``' plain version: each interval's verdict as
    the row functions give it.

    plan (5, n) int32: the columns qws, qwe, t0, rws0, n_steps.  The query
    sketches; phase A's span [rws0, span_end) with span_end the first
    locus >= t0 + n_steps + L; for the eligible intervals (qwe - qws <= SQ,
    s > 0) not pruned by phase A, phase B's windows: t0 and, for each span
    locus, clip(loc + 1, t0, t0 + n_steps) and clip(loc - L + 1, ...),
    their [a, b) by ``torch.searchsorted``, each window's ideal, and the
    largest an interval.  Returns (n, 2) int32: 1 where phase A prunes the
    interval, 2 where phase B does, else 0; and its composition rows
    (2 span_n + 1 where phase B ran, else 0)."""
    n = plan.shape[1]
    dev = plan.device
    if n == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=dev)
    qws, qwe, t0, rws0, n_steps = (c.contiguous() for c in plan.unbind(0))
    qk_all, s_all, limit, qovf = _window_sketches_torch(q_keys, qws, qwe,
                                                        limit_lut, SQ)
    locs = r_locs.long()
    t0 = t0.long()
    t1 = t0 + n_steps.long()
    span_end = torch.searchsorted(locs, t1 + L, side="left")
    span_i = torch.cat([
        _span_intersections_torch(r_keys, qk_all[i:i + SPAN_BATCH],
                                  rws0[i:i + SPAN_BATCH],
                                  span_end[i:i + SPAN_BATCH].int(), SA,
                                  n_shift)
        for i in range(0, n, SPAN_BATCH)])
    eligible = ~qovf & (s_all > 0)
    pruned_a = eligible & (span_i < limit)
    alive = eligible & ~pruned_a
    span_n = (span_end - rws0.long()).clamp(min=0)
    rows = torch.where(alive, 2 * span_n + 1, 0).to(torch.int32)

    ideal_max = torch.zeros(n, dtype=torch.int32, device=dev)
    row_iv, wa, wb = _composition_windows(locs, t0, t1, rws0, span_n,
                                          torch.nonzero(alive).flatten(), L)
    for off in range(0, row_iv.shape[0], ROW_BATCH):
        part = slice(off, off + ROW_BATCH)
        ideal = _composition_ideals_torch(r_keys, qk_all, s_all, wa[part],
                                          wb[part], row_iv[part].int(), RW,
                                          n_shift)
        ideal_max.scatter_reduce_(0, row_iv[part], ideal, "amax")
    pruned_b = alive & (ideal_max < limit)
    verdict = torch.where(pruned_a, 1, torch.where(pruned_b, 2, 0))
    return torch.stack([verdict.to(torch.int32), rows], dim=1)


# csrc/prefilter_intervals.cu's entry point and its C signature
_INTERVALS_C = ("sedef_prefilter_intervals", [ctypes.c_void_p] * 6
                + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def _interval_verdicts(q_keys, r_keys, r_locs, limit_lut, plan, L: int,
                       SQ: int, RW: int, SA: int, n_shift: int,
                       tile: int = INTERVAL_TILE):
    """The intervals' verdicts, as ``_interval_verdicts_torch``: on CUDA
    tensors one launch of ``csrc/prefilter_intervals.cu`` (a block an
    interval, ``tile`` span loci staged at a time) on the current stream
    (no synchronisation), on CPU tensors the plain version.  The plan's
    columns are not negative and rws0 <= len(r_locs) (the native plan's
    rws0 is the first locus >= t0)."""
    dev = kernels.same_device(q_keys, r_keys, r_locs, limit_lut, plan)
    if dev.type == "cpu":
        return _interval_verdicts_torch(q_keys, r_keys, r_locs, limit_lut,
                                        plan, L, SQ, RW, SA, n_shift)
    for name, t, nd in (("q_keys", q_keys, 1), ("r_keys", r_keys, 1),
                        ("r_locs", r_locs, 1), ("limit_lut", limit_lut, 1),
                        ("plan", plan, 2)):
        kernels.check(t, torch.int32, nd, name)
    if plan.shape[0] != 5:
        raise ValueError("plan must hold the five columns qws, qwe, t0, "
                         "rws0, n_steps")
    if r_locs.shape[0] != r_keys.shape[0]:
        raise ValueError("r_keys and r_locs must have one length")
    if q_keys.shape[0] < 1 or r_keys.shape[0] < 1 or limit_lut.shape[0] < 1:
        raise ValueError("empty keys or limit table")
    if not (1 <= SQ <= 1024 and 1 <= RW <= 256 and SA >= 0 and L >= 0
            and 1 <= tile <= 4096):
        raise ValueError(f"SQ {SQ}, RW {RW}, SA {SA}, L {L} or tile {tile} "
                         f"out of the kernel's range")
    n = plan.shape[1]
    rec = torch.empty((n, 2), dtype=torch.int32, device=dev)
    if n:
        kernels.launch(KERNEL_WRAPPERS[0], dev,
                       kernels.function(*_INTERVALS_C), q_keys.data_ptr(),
                       r_keys.data_ptr(), r_locs.data_ptr(),
                       limit_lut.data_ptr(), plan.data_ptr(), rec.data_ptr(),
                       n, q_keys.shape[0], r_keys.shape[0],
                       limit_lut.shape[0], SQ, RW, SA, L, n_shift, tile)
    return rec


# the wrapper that launches this module's kernel, with its launch count;
# counted through this tuple, so that a caller that wraps the module's
# ``_interval_verdicts`` (chip_smoke.py's op timer) leaves the count alone
KERNEL_WRAPPERS = (_interval_verdicts,)
_interval_verdicts.launches = 0


class PendingPrefilter:
    """In-flight prefilter verdicts: the pair's launch and the pull of its
    records are queued on the device and ``collect()`` waits for them.
    Keeping dispatch and collect separate lets the pipeline queue one
    chromosome pair's device work while it plans or searches the next
    (models/pipeline.py search_job's two-phase loop)."""

    def __init__(self, n, bj, bs, ok, rec=None, done=None):
        self._n = n
        self._bj, self._bs, self._ok = bj, bs, ok
        self._rec, self._done = rec, done

    def collect(self):
        """Wait for the records; returns (best_j, best_steps, ok)."""
        if self._rec is None:
            return self._bj, self._bs, self._ok
        if self._done is not None:
            with trace.span("seed.wait"):
                self._done.synchronize()
        rec = self._rec.numpy()
        self._rec = None
        verdict = rec[:, 0] > 0
        self._bj[verdict] = -1
        self._ok[:] = verdict
        STATS.update({"intervals": self._n,
                      "pruned_a": int((rec[:, 0] == 1).sum()),
                      "pruned_b": int((rec[:, 0] == 2).sum()),
                      "rows": int(rec[:, 1].sum(dtype=np.int64))})
        return self._bj, self._bs, self._ok


class RollPrefilter:
    """Per-interval verdicts in the native ``sedef_search`` results
    contract: (best_j=-1, best_steps=0, ok=True) where the roll provably
    fails the Jaccard gate; ok=False (host rolls) everywhere else."""

    def __init__(self, kmer_size: int, limit_lut: np.ndarray,
                 init_len: int, SQ: int = DEFAULT_SQ, RW: int = DEFAULT_RW,
                 SA: int = DEFAULT_SA, device="cuda"):
        if kmer_size > 14:
            raise ValueError("packed int32 keys need 2k+2 <= 30 (k <= 14)")
        self.n_shift = 2 * kmer_size
        self.device = torch.device(device)
        self.limit_lut = kernels.upload(limit_lut, self.device)
        self.L = int(init_len)
        self.SQ = SQ
        self.RW = RW
        self.SA = SA

    def run(self, q_keys, r_keys, r_locs, qws, qwe, t0, rws0, n_steps):
        """Verdicts for all planned intervals (plan order) — dispatch +
        blocking collect."""
        return self.dispatch(q_keys, r_keys, r_locs, qws, qwe, t0, rws0,
                             n_steps).collect()

    def dispatch(self, q_keys, r_keys, r_locs, qws, qwe, t0, rws0,
                 n_steps) -> PendingPrefilter:
        """Queue the verdicts of all planned intervals (plan order) without
        blocking; the returned handle's ``collect()`` yields them.

        q_keys / r_keys / r_locs: int32 minimizer keys and the ref's loci
        on the prefilter's device; qws/qwe: per-interval query window
        minimizer range; t0/rws0/n_steps: plan interval columns (host
        arrays)."""
        n = len(qws)
        bj = np.zeros(n, np.int32)
        bs = np.zeros(n, np.int32)
        ok = np.zeros(n, bool)
        if n == 0:
            return PendingPrefilter(0, bj, bs, ok)
        cols = np.stack([np.asarray(c, np.int64)
                         for c in (qws, qwe, t0, rws0, n_steps)])
        if ((cols < 0).any() or int(cols[2].max() + cols[4].max())
                + self.L >= 2**31 or int(cols[3].max()) > r_locs.shape[0]):
            raise ValueError("plan columns out of the int32 plan's range")
        plan = kernels.upload(cols, self.device)
        rec = _interval_verdicts(q_keys, r_keys, r_locs, self.limit_lut,
                                 plan, L=self.L, SQ=self.SQ, RW=self.RW,
                                 SA=self.SA, n_shift=self.n_shift)
        rec, done = kernels.pull(rec)
        return PendingPrefilter(n, bj, bs, ok, rec, done)
