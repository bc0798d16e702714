"""The traced run's records: kernel names, the union of device activity,
the gap-DP shape record around the program's own wrappers."""

import numpy as np
import pytest

from harness.spans import Spans
from harness.trace import DeviceTrace, GapDPRecord, short_name


def test_short_names():
    assert short_name("void sedef::(anonymous namespace)::fill_owned<false, "
                      "4, false>(signed char const*, int, sedef::Score)") \
        == "fill_owned"
    assert short_name("(anonymous namespace)::prefilter_intervals_kernel("
                      "(anonymous namespace)::IntervalArgs)") == \
        "prefilter_intervals_kernel"
    assert short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


class _Ev:
    def __init__(self, a, b, name):
        self.time_range = type("R", (), {"start": a * 1e6, "end": b * 1e6})
        self.name = name
        self.device_type = "DeviceType.CUDA"


def _trace(events, h0=100.0, h1=110.0):
    t = DeviceTrace(None)
    t.prof = type("P", (), {"events": lambda self: events})()
    t.h0, t.h1 = h0, h1
    t._read()
    return t


def test_union_counts_overlaps_once_and_names_gaps():
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    t = _trace([_Ev(5.0, 5.000001, mark), _Ev(6.0, 7.0, "fill_owned(x)"),
                _Ev(6.5, 7.5, "walk_window_kernel(y)"),
                _Ev(9.0, 9.5, "Memcpy HtoD (Pinned -> Device)"),
                _Ev(15.0, 15.000001, mark)])
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s == pytest.approx(2.0)
    assert t.device_ops()[0] == ["fill_owned", pytest.approx(1.0)]
    spans = Spans()
    spans.rec["pipeline.search_stage"].append((100.0, 108.0))
    gaps = t.idle_gaps(spans)
    # the longest gap, 9.5 -> 15.0 device = 104.5 -> 110.0 host, middle 107.25
    assert gaps[0] == ["pipeline.search_stage", pytest.approx(5.5)]
    assert len(gaps) == 3


def test_gap_dp_record_wraps_the_aligners_lookup(monkeypatch):
    """On the CPU aligner with every gap DP forced through the kernels'
    plain versions: the record keeps each launch group's lengths once, the
    program's launch counters keep counting, and restore puts it all back."""
    from sedef_tpu_torch.ops import wavefront as wf
    al = wf.WavefrontAligner(device="cpu")
    monkeypatch.setattr(al, "DEVICE_BATCH_MIN", 1, raising=False)
    monkeypatch.setattr(al, "DEVICE_BATCH_MIN_CELLS", 0, raising=False)
    rng = np.random.default_rng(0)
    pairs = [(rng.integers(0, 4, n).astype(np.int8),
              rng.integers(0, 4, m).astype(np.int8))
             for n, m in ((60, 70), (64, 50), (200, 180))]
    before = al.align_batch(pairs)
    launches = wf.backtrack_pack.launches
    real = wf.backtrack_pack
    rec = GapDPRecord(wf)
    rec.install()
    assert wf.backtrack_pack is not real
    after = al.align_batch(pairs)
    wf.backtrack_pack.launches += 1  # as _launch counts a launch on a card
    rec.restore()
    assert wf.backtrack_pack is real
    assert after == before
    # on the CPU the plain versions count no launches; on the card the
    # wrapper carries the counter and restore hands it back
    assert real.launches == launches + 1
    got = sorted((int(q), int(t)) for ql, tl in rec.lengths()
                 for q, t in zip(ql, tl) if (q, t) != (1, 1))
    assert got == sorted((len(q), len(t)) for q, t in pairs)


def test_cluster_fill_reads_its_kernel_a_unit():
    from harness import loader
    read = loader.metric("cluster_fill.ms_per_genome").read
    t = _trace([_Ev(6.0, 6.5, "void tile_fill_cluster<0, 4>(signed char "
                    "const*, int, int)"),
                _Ev(7.0, 7.25, "void tile_fill_cluster<1, 2>(x)"),
                _Ev(8.0, 9.0, "fill_owned(x)")])
    assert read({"trace": t, "n": 5}) == pytest.approx(1e3 * 0.75 / 5)
    t = _trace([_Ev(8.0, 9.0, "fill_owned(x)")])
    assert read({"trace": t, "n": 5}) is None


def _span(sid, name, t0, t1, thread="MainThread", parent=0):
    return {"id": sid, "parent": parent, "root": sid, "name": name,
            "t0": t0, "t1": t1, "thread": thread}


def test_idle_gaps_name_the_program_spans_open_on_each_thread():
    """A gap at device 9.5 -> 15.0 is host 104.5 -> 110.0, middle 107.25:
    each thread's innermost program span open then, counted by name, the
    most common first, four names at most and ``+k`` for the rest; without
    a snapshot, or where no program span is open, the name stays the
    benchmark's."""
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    t = _trace([_Ev(5.0, 5.000001, mark), _Ev(6.0, 9.5, "fill_owned(x)"),
                _Ev(15.0, 15.000001, mark)])
    spans = Spans()
    spans.rec["pipeline.OverlappedTail.finish"].append((100.0, 110.0))
    snap = {"spans": [
        _span(1, "genome", 100.0, 110.0),
        # an outer span and the inner one open at 107.25: the inner counts
        _span(2, "region", 106.0, 108.0, "T0"),
        _span(3, "region.anchors", 107.0, 107.5, "T0", parent=2),
        _span(4, "region", 107.0, 107.3, "T1"),
        _span(5, "region.anchors", 107.2, 107.4, "T2"),
        _span(6, "gapdp.card.wait", 107.1, 107.26, "T3"),
        _span(7, "tail.stats", 107.25, 107.9, "T4"),
        _span(8, "region.anchors", 107.0, 107.6, "T5"),
        # closed before the middle, and on a thread with nothing open
        _span(9, "gapdp.host", 106.0, 107.0, "T6"),
    ], "counters": {}}
    gaps = t.idle_gaps(spans, program=snap)
    assert gaps[0] == [
        "pipeline.OverlappedTail.finish > region.anchors×3, "
        "gapdp.card.wait×1, genome×1, region×1, +1", pytest.approx(5.5)]
    assert t.idle_gaps(spans)[0][0] == "pipeline.OverlappedTail.finish"
    # the other gap (device 5 -> 6 = host 100 -> 101): the main thread's
    assert t.idle_gaps(spans, program=snap)[1] == [
        "pipeline.OverlappedTail.finish > genome×1", pytest.approx(1.0)]
    only = {"spans": [_span(1, "region", 107.0, 107.3, "T1")]}
    assert [g[0] for g in t.idle_gaps(spans, program=only)] == [
        "pipeline.OverlappedTail.finish > region×1",
        "pipeline.OverlappedTail.finish"]


def test_program_readers_on_a_fabricated_snapshot():
    """Span sums and self times a unit, the router's counters; None where
    the window recorded no such span, or without a program trace."""
    from harness import loader
    snap = {"spans": [
        _span(1, "region", 0.0, 1.0, "T0"),
        _span(2, "region.anchors", 0.1, 0.3, "T0", parent=1),
        _span(3, "gapdp.card", 0.2, 0.6, "T0", parent=1),
        _span(4, "region", 0.5, 0.9, "T1"),
        _span(5, "coalesce.wait", 0.5, 0.7, "T1", parent=4),
        _span(6, "seed.wait", 2.0, 2.25),
    ], "counters": {"gapdp": {
        "problems.card": 30, "cells.card": 300, "cells.host": 100,
        "groups.direct": 4, "groups.streamed": 1, "groups.tiled": 1,
        "groups.streamed-tiled": 0}}}
    ctx = {"n": 2, "program": snap}

    def read(name):
        return loader.metric(name).read(ctx)
    # T0: 1.0 less the union of 0.1-0.3 and 0.2-0.6; T1: 0.4 less 0.2
    assert read("region_self.ms_per_genome") == pytest.approx(1e3 * 0.7 / 2)
    assert read("region_self.ms_per_pair") == pytest.approx(1e3 * 0.7 / 2)
    assert read("anchors.ms_per_pair") == pytest.approx(1e3 * 0.2 / 2)
    assert read("carddp.ms_per_genome") == pytest.approx(1e3 * 0.4 / 2)
    assert read("coalesce_wait.ms_per_genome") == pytest.approx(100.0)
    assert read("seed_wait.ms_per_pair") == pytest.approx(125.0)
    assert read("seed_wait.ms_per_genome") == pytest.approx(125.0)
    assert read("hostdp.ms_per_pair") is None
    assert read("gapdp.card_cells_pct.pairs") == pytest.approx(75.0)
    assert read("gapdp.card_cells_pct.genome") == pytest.approx(75.0)
    assert read("gapdp.problems_per_group.pairs") == pytest.approx(5.0)
    snap["counters"]["gapdp"] = dict.fromkeys(snap["counters"]["gapdp"], 0)
    assert read("gapdp.card_cells_pct.pairs") is None
    assert read("gapdp.problems_per_group.pairs") is None
    assert loader.metric("anchors.ms_per_pair").read({"n": 2}) is None
