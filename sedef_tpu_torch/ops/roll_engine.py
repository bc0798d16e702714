"""Counterpart of ``sedef_tpu/ops/roll_engine.py``.

Batched device roll engine: stage-1 sliding-Jaccard scans as tensor ops.

The reference's hottest loop (``src/search.cc:289-315``) rolls a ~700 bp
reference window one base at a time over each candidate interval,
maintaining an incremental ordered-map MinHash sketch
(``src/sliding.cc``) whose intersection counter is *path-dependent*
(a ref bit landing exactly on the boundary element is not counted —
sliding.cc:86) — so the value cannot be recomputed from window content;
the op stream itself must be replayed.  This module replays a batch of
those op streams side by side:

* the sketch is one sorted int32 row per interval — ``key << 2 | flags``
  (query=1, ref=2; a real key needs 2k+2 <= 28 bits, so the packed store
  requires k <= 13; the reference default is k = 12) — padded with INF,
* insert/delete are masked vector shifts; the boundary index, the
  intersection counter and all four quirk branches of ``SlidingJaccard``
  (ops/sliding.py) are reproduced literally, per row,
* each roll step applies at most one conditional ref-remove and one
  conditional ref-add (minimizer loci are strictly increasing), exactly
  like the scalar loop,
* outputs per interval: the best (earliest, strictly-improving) signed
  jaccard and its step count — the host engine replays only the winner's
  prefix for surviving intervals and skips failed intervals entirely.

An interval's op stream is fully determined by (query window, t_start,
t_end, reference index), so results are exact whenever the production
pass encounters the same interval tuple; windows whose candidate set was
altered by hit-tree dedup fall back to the host roll (see
models/seeder.py / native sedef_search).

On a card a chromosome pair's intervals of both T classes are one launch
of ``csrc/roll_engine.cu`` (a warp per interval, its row in registers,
every step inside the kernel), longest first, with one upload of the plan
and one pull of the results; ``_roll_batch_torch`` is its plain version,
~60 tensor ops on (batch, W) int32 rows a roll step, launched one after
another from a Python loop, which the CPU runs batch by batch and class by
class.  Intervals longer than the last T class roll on the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import trace
from ..native import kernels

INF32 = 2**31 - 1
INT32_MIN = -2**31

DEFAULT_W = 512
DEFAULT_SQ = 160
DEFAULT_INIT_PAD = 192
# roll-length classes: an interval of more steps than the last one rolls
# on the host (ok=False)
T_PAD_LADDER = (512, 4096)
DEFAULT_BATCH = 1024
# the row widths the kernel is built for (32 lanes of W / 32 entries)
KERNEL_W = (64, 512)


def _take1(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[b, idx[b]] for every row b, indexed as the reference's
    ``take_along_axis``: an index in [-W, 0) counts from the row's end
    (the boundary index of an empty query window is -1, and falls further
    with every ref key inserted before the boundary), one below -W reads
    INT32_MIN."""
    W = a.shape[1]
    idx = torch.where(idx < 0, idx + W, idx)
    got = a.gather(1, idx.clamp(min=0)[:, None].long())[:, 0]
    return torch.where(idx < 0, INT32_MIN, got)


def _gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[min(idx, n - 1)] for a 1-d ``a`` (the caller masks the clamped
    lanes)."""
    return a[torch.clamp(idx, max=a.shape[0] - 1).long()]


def _vadd(st, h, bit: int, do, col):
    """SlidingJaccard._add(h, bit) (ops/sliding.py:67-86), vectorized.

    st = (store, ln, Bp, inter, ovf); h (B,) int32 keys; do (B,) bool;
    col (1, W) int32 column index.
    """
    store, ln, Bp, inter, ovf = st
    W = store.shape[1]
    hs = h[:, None]

    pos = ((store >> 2) < hs).sum(dim=1, dtype=torch.int32)
    cur = _take1(store, torch.clamp(pos, max=W - 1))
    exists = ((cur >> 2) == h) & (pos < W)
    flag_h = torch.where(exists, cur & 3, 0)
    already = exists & ((flag_h & bit) != 0)
    eff = do & ~already
    ins = eff & ~exists
    full = ins & (ln >= W)
    ovf = ovf | full
    ins = ins & ~full
    eff = eff & ~full

    posb = pos[:, None]
    # existing element: flags |= bit
    store = torch.where((eff & exists)[:, None] & (col == posb),
                        store | bit, store)
    # insertion: shift right at pos
    shift_r = torch.cat([store[:, :1], store[:, :-1]], dim=1)
    inserted = torch.where(col < posb, store,
                           torch.where(col == posb, (hs << 2) | bit,
                                       shift_r))
    store = torch.where(ins[:, None], inserted, store)
    ln = ln + ins
    # keep B pointing at the same element (sliding.py:79-80)
    Bp = Bp + (ins & (pos <= Bp))

    # boundary branch (sliding.py:81-85): state AFTER the insert
    bcur = _take1(store, torch.clamp(Bp, max=W - 1))
    cond = eff & (h < (bcur >> 2))  # query_size > 0 always in roll use
    new_flag = torch.where(exists, flag_h | bit, bit)
    inter = inter + (cond & (new_flag == 3))
    dec = cond & ins
    inter = inter - (dec & ((bcur & 3) == 3)).to(torch.int32)
    Bp = Bp - dec.to(torch.int32)
    return (store, ln, Bp, inter, ovf)


def _vremove(st, h, bit: int, do, col):
    """SlidingJaccard._remove(h, bit) (ops/sliding.py:88-109), vectorized."""
    store, ln, Bp, inter, ovf = st
    B, W = store.shape
    hs = h[:, None]

    pos = ((store >> 2) < hs).sum(dim=1, dtype=torch.int32)
    cur = _take1(store, torch.clamp(pos, max=W - 1))
    found = ((cur >> 2) == h) & (pos < W)
    flag_h = torch.where(found, cur & 3, 0)
    eff = do & found & ((flag_h & bit) != 0)
    erase = eff & (flag_h == bit)

    # boundary branch first (state BEFORE the physical removal)
    bcur = _take1(store, torch.clamp(Bp, max=W - 1))
    cond = eff & (h <= (bcur >> 2))
    inter = inter - (cond & (flag_h == 3)).to(torch.int32)
    step = cond & erase
    Bp2 = Bp + step
    b2 = _take1(store, torch.clamp(Bp2, max=W - 1))
    inter = inter + (step & (Bp2 < ln) & ((b2 & 3) == 3))
    Bp = Bp2

    # physical erase / flag clear
    posb = pos[:, None]
    shift_l = torch.cat(
        [store[:, 1:],
         torch.full((B, 1), INF32, dtype=torch.int32, device=store.device)],
        dim=1)
    erased = torch.where(col < posb, store, shift_l)
    cleared = torch.where(col == posb, store & ~bit, store)
    store = torch.where(erase[:, None], erased,
                        torch.where((eff & ~erase)[:, None], cleared, store))
    ln = ln - erase.to(torch.int32)
    Bp = Bp - (erase & (pos < Bp)).to(torch.int32)
    return (store, ln, Bp, inter, ovf)


def _roll_batch_torch(r_keys, r_locs, nr: int, limit_lut,
                      q_keys, qws, qwe, t0, rws0, init_cnt, n_steps, re0,
                      W: int, SQ: int, INIT_PAD: int, T_PAD: int,
                      n_shift: int, init_max: int | None = None,
                      steps_max: int | None = None):
    """One batch of interval rolls, as tensor ops (``_roll_batch``'s plain
    version).  All interval arrays are (B,) int32
    tensors; r_keys/r_locs/q_keys are the minimizer arrays, on the same
    device.  ``init_max`` / ``steps_max`` (the batch's largest init_cnt
    and n_steps, where the caller knows them) end the two loops early:
    the iterations past them change no row.

    Returns (best_j, best_steps, ok) — ok False where the sketch exceeded
    its W/SQ capacity or the interval its T class (the host rolls those
    intervals).
    """
    B = qws.shape[0]
    dev = qws.device
    col = torch.arange(W, dtype=torch.int32, device=dev)[None, :]

    # ---- initial query-only sketch: sorted distinct window keys,
    # flags=1, B = s-1, intersection = 0 (closed form, seeder.py) ----
    gidx = qws[:, None] + col[:, :SQ]
    val = gidx < qwe[:, None]
    qk = torch.where(val, _gather(q_keys, gidx), INF32)
    qk = torch.sort(qk, dim=1).values
    dupm = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                      qk[:, 1:] == qk[:, :-1]], dim=1)
    qk = torch.where(dupm | (qk == INF32), INF32, qk)
    qk = torch.sort(qk, dim=1).values
    s = (qk != INF32).sum(dim=1, dtype=torch.int32)
    limit = limit_lut[torch.clamp(s, max=limit_lut.shape[0] - 1).long()]
    ovf0 = (qwe - qws) > SQ

    store = torch.full((B, W), INF32, dtype=torch.int32, device=dev)
    store[:, :SQ] = torch.where(qk != INF32, (qk << 2) | 1, INF32)
    st = (store, s, s - 1, torch.zeros(B, dtype=torch.int32, device=dev),
          ovf0)

    def has_n(h):
        return (h >> n_shift) == 2

    # ---- phase A: add_to_reference over the initial window ----
    n_init = INIT_PAD if init_max is None else min(INIT_PAD, init_max)
    for i in range(n_init):
        h = _gather(r_keys, rws0 + i)
        st = _vadd(st, h, 2, (i < init_cnt) & ~has_n(h), col)
    ovf_init = init_cnt > INIT_PAD

    def jaccard(st):
        inter = st[3]
        return torch.where(inter >= limit, inter, inter - limit)

    # ---- phase B: the roll (search.cc:289-315 / native search_interval) --
    rws, rwe, rs, re = rws0, rws0 + init_cnt, t0, re0
    best_j = jaccard(st)
    best_steps = torch.zeros(B, dtype=torch.int32, device=dev)
    n_roll = T_PAD if steps_max is None else min(T_PAD, steps_max)
    for t in range(n_roll):
        active = t < n_steps
        # conditional remove: locs[rws] < rs + 1
        loc_r = _gather(r_locs, rws)
        h_r = _gather(r_keys, rws)
        can_r = active & (rws < nr) & (loc_r < rs + 1)
        st = _vremove(st, h_r, 2, can_r & ~has_n(h_r), col)
        rws = rws + can_r
        # conditional add: locs[rwe] == re
        loc_a = _gather(r_locs, rwe)
        h_a = _gather(r_keys, rwe)
        can_a = active & (rwe < nr) & (loc_a == re)
        st = _vadd(st, h_a, 2, can_a & ~has_n(h_a), col)
        rwe = rwe + can_a
        # strict improvement, earliest wins
        j = jaccard(st)
        upd = active & (j > best_j)
        best_j = torch.where(upd, j, best_j)
        best_steps = torch.where(upd, t + 1, best_steps)
        rs = rs + active
        re = re + active
    ok = ~(st[4] | ovf_init | (n_steps > T_PAD))
    return best_j, best_steps, ok


# csrc/roll_engine.cu's entry point and its C signature
_ROLL_BATCH_C = ("sedef_roll_batch", [ctypes.c_void_p] * 14
                 + [ctypes.c_int] * 11 + [ctypes.c_void_p])


def _roll_batch(r_keys, r_locs, nr: int, limit_lut,
                q_keys, qws, qwe, t0, rws0, init_cnt, n_steps, re0,
                W: int, SQ: int, INIT_PAD: int, T_PAD: int, n_shift: int,
                init_max: int | None = None, steps_max: int | None = None,
                out=None):
    """Interval rolls: (best_j, best_steps, ok), as ``_roll_batch_torch``.
    On CUDA tensors one launch of ``csrc/roll_engine.cu`` on the current
    stream (no synchronisation; W one of ``KERNEL_W``; ``init_max`` /
    ``steps_max`` are not needed there: each interval loops to its own
    counts); on CPU tensors the plain version.  ``out``: the three
    outputs' tensors to write (``_roll_record``), returned."""
    cols = (qws, qwe, t0, rws0, init_cnt, n_steps, re0)
    arrays = (r_keys, r_locs, q_keys, limit_lut)
    dev = kernels.same_device(*arrays, *cols)
    if dev.type == "cpu":
        got = _roll_batch_torch(r_keys, r_locs, nr, limit_lut, q_keys,
                                *cols, W=W, SQ=SQ, INIT_PAD=INIT_PAD,
                                T_PAD=T_PAD, n_shift=n_shift,
                                init_max=init_max, steps_max=steps_max)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return out
    for name, t in zip(("r_keys", "r_locs", "q_keys", "limit_lut", "qws",
                        "qwe", "t0", "rws0", "init_cnt", "n_steps", "re0"),
                       arrays + cols):
        kernels.check(t, torch.int32, 1, name)
    B = qws.shape[0]
    if any(c.shape[0] != B for c in cols):
        raise ValueError("the plan columns must have one length")
    if min(t.shape[0] for t in arrays) < 1:
        raise ValueError("empty minimizer array or limit table")
    if W not in KERNEL_W:
        raise ValueError(f"the kernel's row takes W in {KERNEL_W}, not {W}")
    if not 1 <= SQ <= W:
        raise ValueError(f"the row (W={W}) must hold the query's SQ={SQ}")
    best_j, best_steps, ok = _roll_record(B, dev)[1] if out is None else out
    if B:
        kernels.launch(KERNEL_WRAPPERS[0], dev,
                       kernels.function(*_ROLL_BATCH_C),
                       *(t.data_ptr() for t in arrays + cols),
                       best_j.data_ptr(), best_steps.data_ptr(),
                       ok.data_ptr(), B, r_keys.shape[0], r_locs.shape[0],
                       q_keys.shape[0], limit_lut.shape[0], int(nr), W, SQ,
                       INIT_PAD, T_PAD, n_shift)
    return best_j, best_steps, ok


def _roll_record(B: int, dev):
    """One buffer of 9 B bytes for a roll's outputs, and its three views:
    best_j and best_steps (B,) int32, ok (B,) bool (one pull reads all)."""
    rec = torch.empty(9 * B, dtype=torch.uint8, device=dev)
    return rec, (rec[:4 * B].view(torch.int32),
                 rec[4 * B:8 * B].view(torch.int32),
                 rec[8 * B:].view(torch.bool))


# the wrapper that launches this module's kernel, with its launch count;
# counted through this tuple, so that a caller that wraps the module's
# ``_roll_batch`` (chip_smoke.py's op timer) leaves the count alone
KERNEL_WRAPPERS = (_roll_batch,)
_roll_batch.launches = 0


def _t_classes(n_steps) -> np.ndarray:
    """Each interval's roll-length class: the smallest T of T_PAD_LADDER
    >= its n_steps, 0 past the last (the host rolls those)."""
    ladder = np.asarray(T_PAD_LADDER, np.int32)
    i = np.searchsorted(ladder, np.asarray(n_steps), side="left")
    return np.where(i < len(ladder), ladder[np.minimum(i, len(ladder) - 1)],
                    0).astype(np.int32)


class RollEngine:
    """Rolls planned intervals on the device the minimizer arrays live on:
    on a card all of a pair's intervals in one launch (``_run_merged``),
    on the CPU by roll-length class in batches.  ``run`` takes the plan
    arrays (see native sedef_search_plan) plus the int32 minimizer
    key/loc tensors and returns per-interval (best_j, best_steps, ok) in
    plan order."""

    def __init__(self, kmer_size: int, limit_lut: np.ndarray,
                 W: int = DEFAULT_W, SQ: int = DEFAULT_SQ,
                 INIT_PAD: int = DEFAULT_INIT_PAD,
                 batch: int = DEFAULT_BATCH):
        if kmer_size > 13:
            raise ValueError("packed store needs 2k+4 <= 32 bits (k <= 13)")
        self.n_shift = 2 * kmer_size
        self.limit_lut = np.ascontiguousarray(limit_lut, np.int32)
        self.W, self.SQ, self.INIT_PAD = W, SQ, INIT_PAD
        self.batch = batch

    def run(self, q_keys, r_keys, r_locs, nr: int, rlen: int,
            qws, qwe, t0, rws0, init_cnt, n_steps, re0):
        plan = np.stack([np.asarray(c, np.int32) for c in
                         (qws, qwe, t0, rws0, init_cnt, n_steps, re0)])
        if r_keys.device.type == "cuda":
            return self._run_merged(q_keys, r_keys, r_locs, nr, plan)
        n = plan.shape[1]
        best_j = np.zeros(n, np.int32)
        best_steps = np.zeros(n, np.int32)
        ok = np.zeros(n, bool)
        dev = r_keys.device
        lut = torch.from_numpy(self.limit_lut).to(dev)
        tclass = _t_classes(plan[5])
        for T in T_PAD_LADDER:  # class 0: the host rolls them
            sel = np.nonzero(tclass == T)[0]
            for off in range(0, len(sel), self.batch):
                part = sel[off:off + self.batch]
                args = torch.from_numpy(np.ascontiguousarray(plan[:, part]))
                bj, bs, okk = _roll_batch(
                    r_keys, r_locs, nr, lut, q_keys, *args.to(dev).unbind(0),
                    W=self.W, SQ=self.SQ, INIT_PAD=self.INIT_PAD,
                    T_PAD=T, n_shift=self.n_shift,
                    init_max=int(plan[4, part].max()),
                    steps_max=int(plan[5, part].max()))
                best_j[part] = bj.cpu().numpy()
                best_steps[part] = bs.cpu().numpy()
                ok[part] = okk.cpu().numpy()
        return best_j, best_steps, ok

    def _run_merged(self, q_keys, r_keys, r_locs, nr: int, plan):
        """``run`` as the card does it: one launch over every interval of a
        T class at the last class's T_PAD (an interval's class is the
        smallest T >= its n_steps, so no cap binds and ``ok`` is the
        same), longest first, so that the long chains start first; one
        upload of the limit table and the (7, m) plan, one pull of the
        9 m-byte record.  Runs on any device (the CPU: the plain version
        over the merged plan)."""
        n = plan.shape[1]
        best_j = np.zeros(n, np.int32)
        best_steps = np.zeros(n, np.int32)
        ok = np.zeros(n, bool)
        if (plan < 0).any():
            raise ValueError("the plan's columns must not be negative")
        sel = np.nonzero(_t_classes(plan[5]))[0]
        order = sel[np.argsort(-plan[5, sel], kind="stable")]
        m = len(order)
        if m == 0:
            return best_j, best_steps, ok
        dev = r_keys.device
        nl = len(self.limit_lut)
        buf = kernels.upload(np.concatenate([self.limit_lut,
                                             plan[:, order].ravel()]), dev)
        rec, out = _roll_record(m, dev)
        _roll_batch(r_keys, r_locs, nr, buf[:nl], q_keys,
                    *buf[nl:].view(7, m).unbind(0), W=self.W, SQ=self.SQ,
                    INIT_PAD=self.INIT_PAD, T_PAD=T_PAD_LADDER[-1],
                    n_shift=self.n_shift, init_max=int(plan[4, order].max()),
                    steps_max=int(plan[5, order[0]]), out=out)
        host, done = kernels.pull(rec)
        if done is not None:
            with trace.span("seed.wait"):
                done.synchronize()
        host = host.numpy()
        best_j[order] = host[:4 * m].view(np.int32)
        best_steps[order] = host[4 * m:8 * m].view(np.int32)
        ok[order] = host[8 * m:].view(bool)
        return best_j, best_steps, ok
