"""Counterpart of ``sedef_tpu/native/lib.py``.

ctypes loader for the C++ native runtime (libsedef_native.so).

The native library accelerates sequential host-side hot loops (winnowing
scan, stage-1 search, chaining DP, the scalar wavefront DP).  Every entry
point has a pure NumPy/Python fallback; ``has`` reports availability.
The library is compiled from the package's own ``native/native.cc`` into
``sedef_tpu_torch/_build/`` at first use (``native/build.py``), once per
process under a lock.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import threading

import numpy as np

_lib = None
_tried = False
_lock = threading.Lock()

_u8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _declare(lib) -> None:
    lib.sedef_winnow.restype = ctypes.c_int64
    lib.sedef_winnow.argtypes = [_i64, ctypes.c_int64, ctypes.c_int, _i64]

    if hasattr(lib, "sedef_winnow_fused"):
        lib.sedef_winnow_fused.restype = ctypes.c_int64
        lib.sedef_winnow_fused.argtypes = [
            _u8, _u8, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            _i64, _i64]
    if hasattr(lib, "sedef_sort_minimizers"):
        lib.sedef_sort_minimizers.restype = ctypes.c_int64
        lib.sedef_sort_minimizers.argtypes = [
            _i64, _i32, ctypes.c_int64, _i64, _i32]

    lib.sedef_kmer_keys.restype = ctypes.c_int64
    lib.sedef_kmer_keys.argtypes = [_u8, _u8, ctypes.c_int64,
                                     ctypes.c_int, _i64]

    lib.sedef_search.restype = ctypes.c_int64
    lib.sedef_search.argtypes = (
        [_i64, _i32, ctypes.c_int64, _i64, _i32, ctypes.c_int64, _u8, _u8,
         ctypes.c_int64] * 2
        + [ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
           ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        # optional device plan (pass None to disable)
        + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        # ref posting bucket index
        + [_i32, ctypes.c_int]
        + [_i32, ctypes.c_int64, _i64])

    if hasattr(lib, "sedef_search_range"):
        lib.sedef_search_range.restype = ctypes.c_int64
        lib.sedef_search_range.argtypes = (
            [_i64, _i32, ctypes.c_int64, _i64, _i32, ctypes.c_int64, _u8,
             _u8, ctypes.c_int64] * 2
            + [ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
               ctypes.c_double, ctypes.c_double, ctypes.c_double,
               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int]
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
               _i32, ctypes.c_int64]
            + [_i32, _i32, ctypes.c_int64, _i64]
            + [_i32, ctypes.c_int]
            + [_i32, ctypes.c_int64, _i64])

    if hasattr(lib, "sedef_search_plan"):
        lib.sedef_search_plan.restype = ctypes.c_int64
        lib.sedef_search_plan.argtypes = [
            _i64, _i32, ctypes.c_int64, ctypes.c_int64,
            _i64, _i32, ctypes.c_int64, _i64, _i32, ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_int,
            _i32, ctypes.c_int,
            _i32, ctypes.c_int64, _i32, ctypes.c_int64, _i64]

    lib.sedef_backtrack.restype = ctypes.c_int64
    lib.sedef_backtrack.argtypes = [
        _u8, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _u8, _i32,
        ctypes.c_int64]

    lib.sedef_align.restype = ctypes.c_int64
    lib.sedef_align.argtypes = [
        _u8, ctypes.c_int32, _u8, ctypes.c_int32, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8, _i32,
        ctypes.c_int64]

    if hasattr(lib, "sedef_populate"):
        # raw-pointer signature: this is called once per alignment in the
        # stats stage and ndpointer from_param validation alone cost ~1 s
        # per 17 K alignments (measured r5)
        lib.sedef_populate.restype = ctypes.c_int64
        lib.sedef_populate.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]

    if hasattr(lib, "sedef_align_batch"):
        lib.sedef_align_batch.restype = ctypes.c_int64
        lib.sedef_align_batch.argtypes = [
            _u8, _i64, _u8, _i64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8, _i32, _i64,
            ctypes.c_int64]

    if hasattr(lib, "sedef_anchors"):
        lib.sedef_anchors.restype = ctypes.c_int64
        lib.sedef_anchors.argtypes = [
            _u8, ctypes.c_int64, _u8, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            _i32, ctypes.c_int64]

    lib.sedef_chain.restype = ctypes.c_int64
    lib.sedef_chain.argtypes = [
        _i32, _i32, _i32, _i32, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        _i32, _i64, ctypes.c_int64]

    if hasattr(lib, "sedef_fast_align"):
        lib.sedef_fast_align.restype = ctypes.c_int64
        lib.sedef_fast_align.argtypes = [
            _u8, ctypes.c_int64, _u8, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i64, ctypes.c_int64, _u8, _i32, ctypes.c_int64]

    if hasattr(lib, "sedef_prof_get"):
        lib.sedef_prof_get.restype = None
        lib.sedef_prof_get.argtypes = [_i64]
        lib.sedef_prof_reset.restype = None
        lib.sedef_prof_reset.argtypes = []


def _L():
    """The loaded library (building it first if needed), or None when it
    cannot be built here (no C++ compiler): callers then take the Python
    fallbacks, exactly as ``sedef_tpu`` does without its library."""
    global _lib, _tried
    if not _tried:
        with _lock:
            if not _tried:
                from .build import build_native
                try:
                    lib = ctypes.CDLL(str(build_native()))
                except (OSError, subprocess.CalledProcessError) as e:
                    print(f"sedef_tpu_torch: native library unavailable "
                          f"({e}); using the Python fallbacks",
                          file=sys.stderr)
                    lib = None
                if lib is not None:
                    _declare(lib)
                _lib = lib
                _tried = True
    return _lib


def has(name: str) -> bool:
    lib = _L()
    return lib is not None and hasattr(lib, "sedef_" + name)


PROF_FIELDS = ("collect", "cluster", "roll", "replay", "extend", "filter",
               "roll_steps", "intervals", "survivors")


def prof_get() -> dict[str, int]:
    """Accumulated per-phase nanoseconds (+counts) of the native search."""
    out = np.zeros(len(PROF_FIELDS), dtype=np.int64)
    if has("prof_get"):
        _L().sedef_prof_get(out)
    return dict(zip(PROF_FIELDS, out.tolist()))


def prof_reset() -> None:
    if has("prof_reset"):
        _L().sedef_prof_reset()


def kmer_keys(code: np.ndarray, cls: np.ndarray, k: int) -> np.ndarray:
    n = code.shape[0] - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    _L().sedef_kmer_keys(np.ascontiguousarray(code),
                         np.ascontiguousarray(cls), code.shape[0], k, out)
    return out


def winnow(code: np.ndarray, cls: np.ndarray, k: int, w: int):
    n = code.shape[0] - k + 1
    if n <= w:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int32)
    if has("winnow_fused"):
        # fused k-mer + change-point scan: never materializes the full
        # per-position key array (1 GB at 125 Mbp)
        cps = np.empty(n, dtype=np.int64)
        ck = np.empty(n, dtype=np.int64)
        cnt = _L().sedef_winnow_fused(np.ascontiguousarray(code),
                                      np.ascontiguousarray(cls),
                                      code.shape[0], k, w, cps, ck)
        first = int(np.searchsorted(cps[:cnt], w, side="right")) - 1
        locs = cps[first:cnt].astype(np.int32)
        return ck[first:cnt].copy(), locs
    if has("kmer_keys"):
        keys = kmer_keys(code, cls, k)
    else:  # pragma: no cover
        from ..ops.winnow import kmer_keys_np
        keys = kmer_keys_np(code, cls, k)
    keys = np.ascontiguousarray(keys)
    out = np.empty(n, dtype=np.int64)
    cnt = _L().sedef_winnow(keys, n, w, out)
    cps = out[:cnt]
    first = int(np.searchsorted(cps, w, side="right")) - 1
    locs = cps[first:].astype(np.int32)
    return keys[locs], locs


def sort_minimizers(keys: np.ndarray, locs: np.ndarray):
    """Stable posting-order sort of (keys, locs) by key (= the exact
    np.argsort(kind="stable") result; native LSD radix)."""
    n = len(keys)
    skeys = np.empty(n, dtype=np.int64)
    slocs = np.empty(n, dtype=np.int32)
    _L().sedef_sort_minimizers(np.ascontiguousarray(keys),
                               np.ascontiguousarray(locs), n, skeys, slocs)
    return skeys, slocs


def search_plan(q_index, r_index, same_genome: bool, cfg):
    """Speculative stage-1 plan (sedef_search_plan): every window/interval
    the production pass can visit, computed with an empty dedup tree.

    Returns (win (n_win, 4) int32 [loc, qws, qwe, n_iv],
             iv (n_iv, 6) int32 [t0, t1, rws0, init_cnt, n_steps, re0])."""
    from ..ops.stat_model import tau

    win_cap = max(len(q_index.keys), 16)
    iv_cap = max(2 * len(q_index.keys), 64)
    counts = np.zeros(2, dtype=np.int64)
    while True:
        win = np.empty(win_cap * 4, dtype=np.int32)
        iv = np.empty(iv_cap * 6, dtype=np.int32)
        rc = _L().sedef_search_plan(
            np.ascontiguousarray(q_index.keys),
            np.ascontiguousarray(q_index.locs),
            len(q_index.keys), len(q_index.seq),
            np.ascontiguousarray(r_index.keys),
            np.ascontiguousarray(r_index.locs),
            len(r_index.keys),
            np.ascontiguousarray(r_index.skeys),
            np.ascontiguousarray(r_index.slocs),
            int(r_index.threshold), len(r_index.seq),
            cfg.search.kmer_size,
            tau(cfg.search.max_edit_error, cfg.search.kmer_size, cfg),
            cfg.search.min_read_size, cfg.search.max_error,
            int(same_genome), int(cfg.internal.do_uppercase_seeds),
            *r_index.posting_buckets(),
            win, win_cap, iv, iv_cap, counts)
        if rc == 0:
            n_win, n_iv = int(counts[0]), int(counts[1])
            return (win[:n_win * 4].reshape(n_win, 4),
                    iv[:n_iv * 6].reshape(n_iv, 6))
        win_cap *= 2
        iv_cap *= 4


def search(q_index, r_index, same_genome: bool, cfg,
           plan=None, results=None) -> np.ndarray:
    """Full initial_search via the native core; returns (n, 5) int32 array
    of (qs, qe, rs, re, jaccard).  Indexes are MinimizerIndex objects.

    ``plan`` ((win, iv) from search_plan) + ``results`` ((best_j,
    best_steps, ok) from the device roll engine, in iv order) let the core
    skip device-resolved rolls; output is byte-identical either way."""
    from ..ops.stat_model import tau

    def args_for(ix):
        return [np.ascontiguousarray(ix.keys),
                np.ascontiguousarray(ix.locs),
                len(ix.keys),
                np.ascontiguousarray(ix.skeys),
                np.ascontiguousarray(ix.slocs),
                int(ix.threshold),
                np.ascontiguousarray(ix.seq.cls),
                np.ascontiguousarray(ix.seq.code),
                len(ix.seq)]

    def vp(a):
        return ctypes.c_void_p(a.ctypes.data)

    if plan is not None:
        win, iv = plan
        win = np.ascontiguousarray(win, np.int32)
        iv = np.ascontiguousarray(iv, np.int32)
        if results is not None:
            bj = np.ascontiguousarray(results[0], np.int32)
            bs = np.ascontiguousarray(results[1], np.int32)
            ok = np.ascontiguousarray(results[2], np.uint8)
        else:
            bj = bs = np.empty(0, np.int32)
            ok = np.zeros(len(iv), np.uint8)
        plan_args = [vp(win), len(win), vp(iv), vp(bj), vp(bs), vp(ok)]
    else:
        plan_args = [None, 0, None, None, None, None]

    cap = 1 << 16
    counters = np.zeros(5, dtype=np.int64)
    while True:
        out = np.empty(cap, dtype=np.int32)
        n = _L().sedef_search(
            *args_for(q_index), *args_for(r_index),
            cfg.search.kmer_size,
            tau(cfg.search.max_edit_error, cfg.search.kmer_size, cfg),
            cfg.search.min_read_size, cfg.search.max_sd_size,
            cfg.search.max_error, cfg.search.max_edit_error,
            cfg.search.gap_frequency, cfg.search.min_uppercase,
            int(same_genome), int(cfg.internal.do_uppercase),
            int(cfg.internal.do_qgram),
            int(cfg.internal.do_uppercase_seeds),
            *plan_args,
            *r_index.posting_buckets(),
            out, cap, counters)
        if n >= 0:
            from ..ops import filter as filt
            for key, idx in zip(
                    ("total", "jaccard", "interval", "lowercase", "qgram"),
                    range(5)):
                filt.COUNTERS.add(key, int(counters[idx]))
            return out[:n * 5].reshape(n, 5)
        cap = int(-n) * 5 + 16


def search_range(q_index, r_index, same_genome: bool, cfg,
                 qi_lo: int, qi_hi: int, next_in: int,
                 tree_in: np.ndarray):
    """One query-range shard of the native initial_search.

    ``tree_in``: (n, 4) int32 incoming dedup rectangles (qs, qe, rs, re);
    ``next_in``: incoming stride position.  Returns (hits (n, 5) int32,
    next_out int, tree_out (m, 4) int32, counters (5,) int64).  Chaining
    shards with each other's outgoing state reproduces ``search`` byte
    for byte (tests/test_shard_search.py)."""
    from ..ops.stat_model import tau

    def args_for(ix):
        return [np.ascontiguousarray(ix.keys),
                np.ascontiguousarray(ix.locs),
                len(ix.keys),
                np.ascontiguousarray(ix.skeys),
                np.ascontiguousarray(ix.slocs),
                int(ix.threshold),
                np.ascontiguousarray(ix.seq.cls),
                np.ascontiguousarray(ix.seq.code),
                len(ix.seq)]

    tree_in = np.ascontiguousarray(tree_in, np.int32).reshape(-1, 4)
    cap = 1 << 14
    tree_cap = max(1 << 12, 4 * len(tree_in))
    counters = np.zeros(5, dtype=np.int64)
    next_out = np.zeros(1, dtype=np.int32)
    n_tree_out = np.zeros(1, dtype=np.int64)
    while True:
        out = np.empty(cap, dtype=np.int32)
        tree_out = np.empty(tree_cap * 4, dtype=np.int32)
        n = _L().sedef_search_range(
            *args_for(q_index), *args_for(r_index),
            cfg.search.kmer_size,
            tau(cfg.search.max_edit_error, cfg.search.kmer_size, cfg),
            cfg.search.min_read_size, cfg.search.max_sd_size,
            cfg.search.max_error, cfg.search.max_edit_error,
            cfg.search.gap_frequency, cfg.search.min_uppercase,
            int(same_genome), int(cfg.internal.do_uppercase),
            int(cfg.internal.do_qgram),
            int(cfg.internal.do_uppercase_seeds),
            qi_lo, qi_hi, next_in, tree_in, len(tree_in),
            next_out, tree_out, tree_cap, n_tree_out,
            *r_index.posting_buckets(),
            out, cap, counters)
        if n >= 0 and int(n_tree_out[0]) <= tree_cap:
            return (out[:n * 5].reshape(n, 5).copy(),
                    int(next_out[0]),
                    tree_out[:int(n_tree_out[0]) * 4].reshape(-1, 4).copy(),
                    counters.copy())
        if n < 0:
            cap = (int(-n) - 1) * 5 + 16
        tree_cap = max(tree_cap * 2, int(n_tree_out[0]))


def align(q: np.ndarray, t: np.ndarray, match: int, mis: int, gapo: int,
          gape: int) -> list[tuple[str, int]]:
    """Full scalar wavefront DP + traceback (small host-side problems)."""
    qlen, tlen = len(q), len(t)
    cap = qlen + tlen + 2
    ops = np.empty(cap, dtype=np.uint8)
    lens = np.empty(cap, dtype=np.int32)
    n = _L().sedef_align(
        np.ascontiguousarray(q, np.uint8), qlen,
        np.ascontiguousarray(t, np.uint8), tlen,
        match, mis, gapo, gape, ops, lens, cap)
    assert n >= 0
    return [(chr(ops[i]), int(lens[i])) for i in range(n)]


def populate(a: bytes, b: bytes, ops: np.ndarray, lens: np.ndarray
             ) -> tuple[bytes, bytes, bytes, int, int]:
    """Gapped strings + midline + (matches, mismatches) in one native
    pass (align.cc:274-315 semantics; see ops/cigar.py populate)."""
    total = int(lens.sum())
    buf = np.empty(3 * total, dtype=np.uint8)
    counts = np.zeros(2, dtype=np.int64)
    base = buf.ctypes.data
    n = _L().sedef_populate(
        a, b, ops.ctypes.data, lens.ctypes.data, len(ops),
        base, base + total, base + 2 * total, total, counts.ctypes.data)
    assert n == total, (n, total)
    bb = buf.tobytes()
    return (bb[:total], bb[total:2 * total], bb[2 * total:],
            int(counts[0]), int(counts[1]))


def align_batch_flat(qbuf: np.ndarray, qoff: np.ndarray, tbuf: np.ndarray,
                     toff: np.ndarray, match: int, mis: int, gapo: int,
                     gape: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched scalar wavefront DP over problems given as flat arrays:
    problem i is ``qbuf[qoff[i]:qoff[i + 1]]`` against
    ``tbuf[toff[i]:toff[i + 1]]`` (uint8 codes, no empty side; the
    offsets n + 1 int64).  One native round trip; returns the CIGAR runs
    as arrays: ops (ASCII, uint8), lengths (int32) and runs a problem
    (int64)."""
    n = len(qoff) - 1
    cap = int(qoff[-1] + toff[-1]) + 2 * n + 16
    ops = np.empty(cap, dtype=np.uint8)
    lens = np.empty(cap, dtype=np.int32)
    cnt = np.zeros(n, dtype=np.int64)
    qbuf, tbuf = (np.ascontiguousarray(b, np.uint8) for b in (qbuf, tbuf))
    qoff, toff = (np.ascontiguousarray(o, np.int64) for o in (qoff, toff))
    r = _L().sedef_align_batch(qbuf, qoff, tbuf, toff, n, match, mis, gapo,
                               gape, ops, lens, cnt, cap)
    assert r >= 0, r
    return ops[:r], lens[:r], cnt


def align_batch(pairs: list, match: int, mis: int, gapo: int,
                gape: int) -> list[list[tuple[str, int]]]:
    """Batched scalar wavefront DP: one native round trip for many
    small (q, t) uint8 code pairs (the dense-SD gap-DP regime).  Empty
    sides must be filtered by the caller."""
    n = len(pairs)
    qoff = np.zeros(n + 1, dtype=np.int64)
    toff = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(q) for q, _ in pairs], out=qoff[1:])
    np.cumsum([len(t) for _, t in pairs], out=toff[1:])
    qbuf = np.concatenate([np.asarray(q, dtype=np.uint8)
                           for q, _ in pairs])
    tbuf = np.concatenate([np.asarray(t, dtype=np.uint8)
                           for _, t in pairs])
    ops, lens, cnt = align_batch_flat(qbuf, qoff, tbuf, toff, match, mis,
                                      gapo, gape)
    out: list[list[tuple[str, int]]] = []
    pos = 0
    opsl = ops.tolist()
    lensl = lens.tolist()
    for c in cnt.tolist():
        out.append([(chr(opsl[j]), lensl[j]) for j in range(pos, pos + c)])
        pos += c
    return out


def backtrack(p: np.ndarray, qlen: int, tlen: int) -> list[tuple[str, int]]:
    p = np.ascontiguousarray(p)
    cap = qlen + tlen + 2
    ops = np.empty(cap, dtype=np.uint8)
    lens = np.empty(cap, dtype=np.int32)
    n = _L().sedef_backtrack(p, p.shape[1], qlen, tlen, ops, lens, cap)
    assert n >= 0
    return [(chr(ops[i]), int(lens[i])) for i in range(n)]


def anchors(query: bytes, ref: bytes, same_chr: bool, oqs: int, ors: int,
            k: int, max_posting: int = 1000) -> np.ndarray:
    """Exact k-mer anchors via the native scan; returns (n, 4) int32
    (q, r, len, has_u) in q-major emission order."""
    qa = np.frombuffer(query, dtype=np.uint8)
    ra = np.frombuffer(ref, dtype=np.uint8)
    cap = 4 * max(1 << 12, len(qa) // 4)
    while True:
        out = np.empty(cap, dtype=np.int32)
        n = _L().sedef_anchors(qa, len(qa), ra, len(ra), int(same_chr),
                               oqs, ors, k, max_posting, out, cap)
        if n >= 0:
            return out[:n * 4].reshape(n, 4).copy()
        if n == -2:
            raise ValueError("sedef_anchors requires k <= 12")
        cap = max(cap * 4, (int(-n) - 1) * 16 + 64)


def fast_align_region(query: bytes, ref: bytes, same_chr: bool, oqs: int,
                      ors: int, k: int, cfg):
    """Full-region stage-2b path (anchors -> chain -> guided assembly ->
    refine) in one native call.  Returns a list of
    (qs, qe, rs, re, matches, mismatches, gap_bases, cigar) tuples in the
    models/aligner.py fast_align emission order, or None when the native
    core bailed (caller uses the Python path — behaviour never diverges)."""
    qa = np.frombuffer(query, dtype=np.uint8)
    ra = np.frombuffer(ref, dtype=np.uint8)
    rp = cfg.chain.refine
    hit_cap = 8 * 64
    cig_cap = 1 << 14
    while True:
        hits = np.empty(hit_cap, dtype=np.int64)
        ops = np.empty(cig_cap, dtype=np.uint8)
        lens = np.empty(cig_cap, dtype=np.int32)
        n = _L().sedef_fast_align(
            qa, len(qa), ra, len(ra), int(same_chr), oqs, ors, k,
            cfg.align.match, cfg.align.mismatch, cfg.align.gap_open,
            cfg.align.gap_extend, cfg.chain.max_chain_gap,
            cfg.chain.match_chain_score, cfg.chain.min_uppercase_match,
            cfg.search.min_read_size, cfg.search.max_error,
            rp.match, rp.mismatch, rp.gap, rp.gap_open,
            rp.min_read, rp.side_align, rp.max_gap,
            hits, hit_cap, ops, lens, cig_cap)
        if n == -1:
            return None
        if n == -2:
            hit_cap *= 4
            continue
        if n == -3:
            cig_cap *= 4
            continue
        out = []
        pos = 0
        opsl = ops.tolist()
        lensl = lens.tolist()
        hl = hits[:n * 8].tolist()
        for i in range(n):
            qs, qe, rs, re, ncig, m, mm, gb = hl[8 * i:8 * i + 8]
            cigar = [(chr(opsl[j]), lensl[j])
                     for j in range(pos, pos + ncig)]
            pos += ncig
            out.append((qs, qe, rs, re, m, mm, gb, cigar))
        return out


def chain(aq, ar, al, ahu, max_chain_gap: int, match_chain_score: int):
    """Returns (path int32 array, boundaries (m, 2) int64 array of
    (end, has_u))."""
    n = len(aq)
    path = np.empty(max(n, 1), dtype=np.int32)
    bcap = 2 * (n + 2)
    bounds = np.empty(bcap, dtype=np.int64)
    nb = _L().sedef_chain(
        np.ascontiguousarray(aq, np.int32),
        np.ascontiguousarray(ar, np.int32),
        np.ascontiguousarray(al, np.int32),
        np.ascontiguousarray(ahu, np.int32), n,
        max_chain_gap, match_chain_score, path, bounds, bcap)
    assert nb >= 0
    boundaries = bounds[:2 * nb].reshape(nb, 2)
    npath = int(boundaries[-1, 0]) if nb else 0
    return path[:npath], boundaries
