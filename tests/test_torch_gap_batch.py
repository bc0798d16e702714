"""A gap-DP batch as flat arrays (``GapBatch``) and its answers as arrays
(``CigarBatch``), held against the list forms: the router, the pack and
the decode give the flat batch, byte for byte, the CIGARs and launch
groups the list form gives, and those are the per-problem ones of the
reference package's ``wavefront_np`` / ``backtrack_np`` and of the
router's list-by-list rules (a copy below).  Also the result type's
sequence behaviour, ``from_anchors_many`` given a plain list,
``CoalescingAligner`` under many threads, and the two wrappers the
benchmark puts around ``align_batch``.  Tolerance: exact equality."""

import random
import sys
import threading
import types

import numpy as np
import pytest
import torch

from sedef_tpu.ops import wavefront as ref_wf
from sedef_tpu_torch import trace
from sedef_tpu_torch.io.bed import Hit, SeqRef
from sedef_tpu_torch.models import aligner as region
from sedef_tpu_torch.models import simulate as sim
from sedef_tpu_torch.native import lib as native
from sedef_tpu_torch.ops import wavefront as wf

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _off_after():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _problem(rng, n, m):
    t = rng.integers(0, 4, max(n, m, 1)).astype(np.uint8)
    q = t.copy()
    mut = rng.random(len(q)) < 0.12
    q[mut] = (q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    return q[:n], t[:m]


def _flat(pairs, rng):
    """``pairs`` as a GapBatch over two shuffled code strings, each
    problem at its own offset with other bases around it."""
    q_parts, t_parts, qo, to = [rng.integers(0, 4, 7).astype(np.uint8)], \
        [rng.integers(0, 4, 5).astype(np.uint8)], [], []
    for q, t in pairs:
        qo.append(sum(map(len, q_parts)))
        to.append(sum(map(len, t_parts)))
        q_parts += [q, rng.integers(0, 4, 3).astype(np.uint8)]
        t_parts += [t, rng.integers(0, 4, 2).astype(np.uint8)]
    return wf.GapBatch(np.concatenate(q_parts), np.concatenate(t_parts), qo,
                       [len(q) for q, _ in pairs], to,
                       [len(t) for _, t in pairs])


def _want(pairs):
    """The per-problem CIGAR: the reference package's full DP and
    traceback, or the degenerate one of an empty side."""
    out = []
    for q, t in pairs:
        if len(q) and len(t):
            p, _ = ref_wf.wavefront_np(q, t)
            out.append(ref_wf.backtrack_np(p, len(q), len(t)))
        else:
            out.append([("D", len(q))] * bool(len(q))
                       + [("I", len(t))] * bool(len(t)))
    return out


def _list_groups(al, pairs):
    """The launch groups of a list under the router's rules, problem by
    problem: (S_q, S_t, problems, K, tile) in launch order."""
    giant = al.GIANT_CELLS if al.device.type == "cuda" \
        else al.NATIVE_MAX_CELLS
    device, host = [], []
    for i, (q, t) in enumerate(pairs):
        if len(q) and len(t):
            (device if (len(q) + len(t)) * len(t) > giant
             else host).append(i)
    if (len(host) >= al.DEVICE_BATCH_MIN and sum(
            len(pairs[i][0]) * len(pairs[i][1]) for i in host)
            >= al.DEVICE_BATCH_MIN_CELLS):
        device += host
    classes = {}
    for i in device:
        key = (wf._pad_to_class(len(pairs[i][0])),
               wf._pad_to_class(len(pairs[i][1])))
        classes.setdefault(key, []).append(i)
    out = []
    for (S_q, S_t), g in classes.items():
        if S_t > al.GIANT_S_T or (S_q + S_t) * S_t > al.GIANT_P_BYTES:
            parts = al.tiled_parts(g, S_q, S_t)
        elif S_t >= al.STREAM_MIN_S_T and len(g) > al.STREAM_MIN_PROBLEMS:
            K = al.stream_k(len(g))
            cap = max(1, al.P_BUDGET_BYTES
                      // (wf._stream_rows(S_q, S_t, K) * S_t)) * K
            parts = [(g[o:o + cap], K, None) for o in range(0, len(g), cap)]
        else:
            cap = max(1, al.P_BUDGET_BYTES // ((S_q + S_t - 1) * S_t))
            parts = [(g[o:o + cap], 1, None) for o in range(0, len(g), cap)]
        out += [(S_q, S_t, list(p), K, tile) for p, K, tile in parts]
    return out


def _spied(al, calls):
    solve = al._solve

    def spy(batch, part, S_q, S_t, K, tile):
        calls.append((S_q, S_t, [int(i) for i in part], K, tile))
        return solve(batch, part, S_q, S_t, K, tile)
    al._solve = spy
    return al


def _routes_aligner():
    """A CPU aligner whose lowered class thresholds send small classes
    down the streamed and tiled routes, and whose byte cap splits a
    class into two launch groups."""
    al = wf.WavefrontAligner(device="cpu")
    al.GIANT_S_T = 256
    al.STREAM_MIN_S_T = 256
    al.STREAM_MIN_PROBLEMS = 4
    al.GIANT_STREAMS = 2
    al.P_BUDGET_BYTES = 6 * 255 * 128   # six (128, 128) problems a group
    return al


@pytest.mark.parametrize("floors", ["card", "host_by_count",
                                    "host_by_cells", "at_floors"])
@pytest.mark.parametrize("seed", range(3))
def test_flat_batch_equals_the_list_form(seed, floors):
    """Random batches over the direct, streamed and tiled routes, with
    degenerate problems mixed in, on both sides of the two batch floors:
    the flat batch gives the list form's CIGARs (and their arrays), its
    launch groups problem for problem and in order, and its counts; the
    launch groups are those of the router's per-problem rules."""
    rng = np.random.default_rng(seed)
    sizes = ([(int(a), int(b)) for a, b in rng.integers(1, 129, (13, 2))]
             + [(int(a), int(b)) for a, b in rng.integers(150, 257, (9, 2))]
             + [(int(a), int(b)) for a, b in rng.integers(300, 513, (5, 2))]
             + [(0, 5), (7, 0), (0, 0)])
    rng.shuffle(sizes)
    pairs = [_problem(rng, n, m) for n, m in sizes]
    cells = sum(n * m for n, m in sizes)
    live = sum(1 for n, m in sizes if n and m)
    runs = {}
    for form in ("list", "flat"):
        al = _routes_aligner()
        al.DEVICE_BATCH_MIN, al.DEVICE_BATCH_MIN_CELLS = {
            "card": (1, 0), "host_by_count": (live + 1, 0),
            "host_by_cells": (1, cells + 1), "at_floors": (live, cells)}[
                floors]
        calls = []
        _spied(al, calls)
        wf.GAPDP.reset()
        got = al.align_batch(pairs if form == "list" else _flat(pairs, rng))
        runs[form] = (got, calls, al.launch_groups, wf.GAPDP.snapshot())
        assert calls == _list_groups(al, pairs)
    (lgot, lcalls, lgroups, lc), (fgot, fcalls, fgroups, fc) = \
        runs["list"], runs["flat"]
    assert isinstance(fgot, wf.CigarBatch) and isinstance(lgot, wf.CigarBatch)
    assert fgot == lgot == _want(pairs)
    for a, b in zip(wf.cigar_runs(fgot), wf.cigar_runs(list(lgot))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert fcalls == lcalls and fgroups == lgroups
    assert fc.pop("flat.problems") == len(pairs)
    assert lc.pop("flat.problems") == 0
    assert fc == lc
    assert (lc["problems.card"] > 0) == (floors in ("card", "at_floors"))
    if floors == "card":
        assert {K > 1 for _, _, _, K, _ in fcalls} == {False, True}
        assert any(tile for *_, tile in fcalls)


def test_cigar_batch_is_the_list_of_its_cigars():
    """``len``, indexing from either end, slices (a batch of those
    problems, or a list with a step), iteration, equality with lists and
    with batches, and ``+`` give what the list of CIGARs gives."""
    want = [[("M", 3), ("I", 2)], [("D", 4)], [], [("I", 1), ("M", 9)]]
    cnt, ops, lens = wf.cigar_runs(want)
    got = wf.CigarBatch(ops, lens, wf._offsets(cnt))
    assert len(got) == 4 and list(got) == want and got == want
    assert want == got and not got != want
    assert got[0] == want[0] and got[-1] == want[-1] and got[2] == []
    with pytest.raises(IndexError):
        got[4]
    for s in (slice(1, 3), slice(None, -1), slice(3, 1), slice(2, None)):
        part = got[s]
        assert isinstance(part, wf.CigarBatch) and part == want[s]
        assert part.first[0] == 0 and len(part.ops) == part.first[-1]
    assert got[::2] == want[::2] and isinstance(got[::2], list)
    assert got == wf.CigarBatch(ops.copy(), lens.copy(), wf._offsets(cnt))
    assert got != want[:3] and got != want[:3] + [[("M", 8)]]
    assert got + want[:1] == want + want[:1] == want + got[:1]
    assert got != "MID" and got != tuple(want)
    assert repr(got).startswith("CigarBatch([[('M', 3)")


def test_gap_batch_is_the_list_of_its_pairs():
    """A flat batch reads as the list of its (q, t) code views: ``len``,
    indexing, slicing, iteration; ``of`` and ``join`` keep the order."""
    rng = np.random.default_rng(2)
    pairs = [_problem(rng, n, m) for n, m in [(5, 7), (0, 3), (9, 0), (4, 4)]]
    flat = _flat(pairs, rng)
    for b in (flat, wf.GapBatch.of(pairs)):
        assert len(b) == 4
        for (q, t), (bq, bt) in zip(pairs, b):
            assert np.array_equal(q, bq) and np.array_equal(t, bt)
        assert np.array_equal(b[-1][0], pairs[-1][0])
        assert [len(q) for q, _ in b[1:3]] == [0, 9]
    joined = wf.GapBatch.join([flat[:2], pairs[2:], wf.GapBatch.of([])])
    assert len(joined) == 4
    for (q, t), (bq, bt) in zip(pairs, joined):
        assert np.array_equal(q, bq) and np.array_equal(t, bt)
    assert wf.GapBatch.of(flat) is flat


def test_host_route_returns_the_native_runs_as_arrays():
    """The host route's arrays are ``native/lib``'s ``ops`` / ``lens`` /
    ``cnt``; the list form of the native call is unchanged."""
    if not native.has("align"):
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(4)
    pairs = [_problem(rng, int(n), int(m))
             for n, m in rng.integers(1, 90, (11, 2))]
    al = wf.WavefrontAligner(device="cpu")
    wf.GAPDP.reset()
    got = al.align_batch(_flat(pairs, rng))
    assert wf.GAPDP["problems.host"] == len(pairs)
    assert got == native.align_batch(pairs, 5, -4, 40, 1) == _want(pairs)


def _region(seed):
    rng = random.Random(seed)
    s1, s2, _ = sim.generate_random_sd(rng, 12, min_len=2500, max_len=3500)
    q = sim.rand_seq(rng, 800) + s1 + sim.rand_seq(rng, 800)
    r = sim.rand_seq(rng, 800) + s2 + sim.rand_seq(rng, 800)
    orig = Hit(SeqRef("A", False, len(q)), 0, len(q),
               SeqRef("B", False, len(r)), 0, len(r))
    return q, r, orig


def _hits(hits):
    return [(h.query_start, h.query_end, h.ref_start, h.ref_end,
             h.aln.cigar, h.aln.align_a, h.aln.align_b) for h in hits]


class _Listing:
    """An aligner whose answers are plain lists (as a wrapper's are)."""

    def __init__(self, base):
        self.base = base
        self.device = base.device

    def align_batch(self, pairs):
        return [list(c) for c in self.base.align_batch(pairs)]

    def align_strings(self, a, b):
        return self.base.align_strings(a, b)


@pytest.mark.parametrize("card", [False, True])
def test_from_anchors_many_takes_a_plain_list(monkeypatch, card):
    """The region path's chains from an aligner answering in lists equal
    those from the flat result, on the host and the card route."""
    monkeypatch.setenv("SEDEF_NATIVE_REGION", "0")
    q, r, orig = _region(3)
    al = wf.WavefrontAligner(device="cpu")
    if card:
        al.DEVICE_BATCH_MIN, al.DEVICE_BATCH_MIN_CELLS = 1, 0
    want = _hits(region.fast_align(q, r, orig, 11, aligner=al))
    assert want
    assert _hits(region.fast_align(q, r, orig, 11,
                                   aligner=_Listing(al))) == want


def test_coalescing_aligner_joins_flat_batches_from_many_threads():
    """Threads submitting flat batches (and a list now and then) through
    one coalescing aligner each get what one call of their own gives: the
    dispatcher joins the requests' arrays and hands each its slice.  The
    base's device reads as a card so that the aligner coalesces; its
    batches run on the CPU routes."""
    rng = np.random.default_rng(6)
    base = wf.WavefrontAligner(device="cpu")
    base.DEVICE_BATCH_MIN, base.DEVICE_BATCH_MIN_CELLS = 6, 20000
    seen = []
    real = base.align_batch

    def counted(pairs):
        seen.append(len(pairs))
        return real(pairs)
    fake = types.SimpleNamespace(device=torch.device("cuda", 0),
                                 cfg=base.cfg, align_batch=counted)
    co = wf.CoalescingAligner(fake, window_s=0.002)
    reqs = []
    for k in range(24):
        pairs = [_problem(rng, int(n), int(m))
                 for n, m in rng.integers(0, 140, (int(rng.integers(1, 9)),
                                                   2))]
        reqs.append(pairs if k % 5 == 4 else _flat(pairs, rng))
    want = [list(real(r)) for r in reqs]
    got = [None] * len(reqs)
    errors = []

    def work(i):
        try:
            got[i] = co.align_batch(reqs[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        seen.clear()
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert [list(g) for g in got] == want
    assert sum(seen) == sum(map(len, reqs)) and len(seen) <= len(reqs)


def _gapdp_log(aligner, units):
    """The benchmark's gap-DP log, in short: it keeps each batch and its
    answers, references only."""
    real = aligner.align_batch

    def align_batch(pairs):
        out = real(pairs)
        units.append((pairs, out))
        return out
    aligner.align_batch = align_batch


def _approximate(real, gap=64):
    """The benchmark's control plant, in short: a long gap DP of unequal
    sides solved as a same-length DP plus one indel."""
    def align_batch(pairs):
        jobs, tails = [], []
        for q, t in pairs:
            mi, ma = min(len(q), len(t)), max(len(q), len(t))
            if mi and ma > gap and mi != ma:
                jobs.append((q[:mi], t[:mi]))
                tails.append(("D" if len(q) > mi else "I", ma - mi))
            else:
                jobs.append((q, t))
                tails.append(None)
        out = real(jobs)
        return [list(c) + ([tl] if tl else []) for c, tl in zip(out, tails)]
    return align_batch


@pytest.mark.parametrize("plant", [False, True])
def test_benchmark_wrappers_see_every_problem(monkeypatch, plant):
    """Around ``align_batch`` on the aligner instance, the log sees every
    gap DP of a region (as many as the router counted) and can zip each
    batch with its answers, each a CIGAR of its problem; under the
    control plant too, where the region path gets lists back."""
    monkeypatch.setenv("SEDEF_NATIVE_REGION", "0")
    q, r, orig = _region(5)
    al = wf.WavefrontAligner(device="cpu")
    al.DEVICE_BATCH_MIN, al.DEVICE_BATCH_MIN_CELLS = 1, 0
    if plant:
        al.align_batch = _approximate(al.align_batch)
    units = []
    _gapdp_log(al, units)
    wf.GAPDP.reset()
    hits = region.fast_align(q, r, orig, 11, aligner=al)
    assert hits and units
    c = wf.GAPDP.snapshot()
    probs = [(pq, pt, ci) for pairs, out in units
             for (pq, pt), ci in zip(pairs, out)]
    assert len(probs) == sum(len(p) for p, _ in units)
    if not plant:
        assert len(probs) == (c["problems.card"] + c["problems.host"]
                              + c["problems.degenerate"])
        assert c["flat.problems"] > 0
    for pq, pt, ci in probs:
        assert sum(n for op, n in ci if op != "I") == len(pq)
        assert sum(n for op, n in ci if op != "D") == len(pt)
