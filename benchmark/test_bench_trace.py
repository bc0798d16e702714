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
