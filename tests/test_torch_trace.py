"""The port's spans and counters (``sedef_tpu_torch/trace.py``): off by
default and free of records then, parents and roots on and across pool
threads, self time, the cap, and the one counter class behind the seed
funnel, the prefilter's and the gap-DP router's counts; then the spans and
counters on the paths they time: a pair through ``classify_pair``, an
``align_batch`` by route, a region's counts by route, and a genome through
the CLI's ``pipeline --trace`` on two threads."""

import json
import random
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from sedef_tpu_torch import trace
from sedef_tpu_torch.models import simulate as sim
from sedef_tpu_torch.ops import filter as filt
from sedef_tpu_torch.ops import prefilter as pf
from sedef_tpu_torch.ops import wavefront as wf

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _off_after():
    """Every test leaves tracing off and its records dropped."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _by_name(snap):
    out = {}
    for s in snap["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_span_is_one_shared_object():
    a = trace.span("a")
    b = trace.span("b", {"route": "x"})
    assert a is b is trace.NOOP
    with a:
        with b:
            pass
    assert trace.carry(len) is len
    assert trace.snapshot()["spans"] == []


def test_nested_spans_give_parent_and_root_ids():
    trace.enable()
    with trace.span("pair"):
        with trace.span("seed", {"k": 1}):
            with trace.span("seed.index"):
                pass
        with trace.span("region"):
            pass
    with trace.span("pair"):
        pass
    trace.disable()
    spans = _by_name(trace.snapshot())
    first, second = spans["pair"]
    assert first["parent"] == 0 and first["root"] == first["id"]
    seed, index, region = spans["seed"][0], spans["seed.index"][0], \
        spans["region"][0]
    assert seed["parent"] == first["id"] and seed["attrs"] == {"k": 1}
    assert index["parent"] == seed["id"]
    assert region["parent"] == first["id"]
    assert {seed["root"], index["root"], region["root"]} == {first["id"]}
    assert second["root"] == second["id"] != first["id"]
    assert first["t0"] <= seed["t0"] <= index["t0"] <= index["t1"] \
        <= seed["t1"] <= region["t0"] <= region["t1"] <= first["t1"]
    assert all(s["thread"] == threading.current_thread().name
               for s in trace.snapshot()["spans"])


def _span(sid, parent, name, t0, t1, thread="t"):
    return {"id": sid, "parent": parent, "root": 1, "name": name, "t0": t0,
            "t1": t1, "thread": thread}


def test_self_time_is_duration_less_the_union_of_children():
    snap = {"spans": [
        _span(1, 0, "region", 0.0, 10.0),
        _span(2, 1, "gapdp.host", 1.0, 3.0),
        _span(3, 1, "gapdp.host", 2.0, 5.0, "u"),   # overlaps 2, on a pool
        _span(4, 1, "region.chain", 7.0, 8.0),
        _span(5, 1, "tail.stats", 9.5, 12.0),      # runs past its parent
        _span(6, 4, "inner", 7.2, 7.4),            # a grandchild
    ]}
    own = trace.self_times(snap)
    assert own[1] == pytest.approx(10.0 - (4.0 + 1.0 + 0.5))
    assert own[4] == pytest.approx(0.8)
    assert own[6] == pytest.approx(0.2)
    assert trace.totals(snap)["gapdp.host"] == pytest.approx(5.0)
    assert trace.self_totals(snap)["region"] == pytest.approx(4.5)


def test_carried_pool_task_takes_the_submitter_span_as_parent():
    def task(k):
        with trace.span("tail.region", {"k": k}):
            return threading.current_thread().name

    trace.enable()
    # one worker: the task submitted without ``carry`` runs on the thread
    # the carried ones ran on, and must find no parent left there
    with ThreadPoolExecutor(max_workers=1) as ex:
        with trace.span("genome"):
            names = list(ex.map(trace.carry(task), range(4)))
            uncarried = ex.submit(task, 9).result()
    trace.disable()
    spans = _by_name(trace.snapshot())
    root = spans["genome"][0]
    carried = [s for s in spans["tail.region"] if s["attrs"]["k"] != 9]
    alone = [s for s in spans["tail.region"] if s["attrs"]["k"] == 9][0]
    assert len(carried) == 4
    assert all(s["parent"] == root["id"] and s["root"] == root["id"]
               for s in carried)
    assert {s["thread"] for s in carried} == set(names)
    assert root["thread"] not in names
    assert alone["parent"] == 0 and alone["root"] == alone["id"]
    assert uncarried in names


def test_reset_clears_spans_and_counters():
    trace.enable()
    with trace.span("a"):
        pass
    wf.GAPDP.add("problems.host", 3)
    filt.COUNTERS.add("total")
    assert trace.snapshot()["spans"]
    trace.reset()
    snap = trace.snapshot()
    assert snap["spans"] == []
    assert all(v == 0 for c in snap["counters"].values() for v in c.values())


def test_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    trace.reset()
    trace.enable()
    for _ in range(5):
        with trace.span("a"):
            pass
    snap = trace.snapshot()
    assert len(snap["spans"]) == 3
    assert snap["counters"]["trace"]["dropped"] == 2
    trace.reset()
    with trace.span("a"):
        pass
    assert len(trace.snapshot()["spans"]) == 1


def test_one_counter_class_serves_the_funnel_and_the_prefilter():
    assert isinstance(filt.COUNTERS, trace.Counters)
    assert isinstance(pf.STATS, trace.Counters)
    assert isinstance(wf.GAPDP, trace.Counters)
    assert list(filt.COUNTERS) == ["total", "jaccard", "interval",
                                   "lowercase", "qgram"]
    assert dict(pf.STATS) == {"intervals": 0, "pruned_a": 0, "pruned_b": 0,
                              "rows": 0}
    filt.COUNTERS.add("jaccard", 2)
    pf.STATS.update({"intervals": 5, "rows": 7})
    assert filt.COUNTERS["jaccard"] == 2
    assert pf.STATS["intervals"] == 5 and dict(pf.STATS)["rows"] == 7
    counters = trace.snapshot()["counters"]
    assert counters["funnel"]["jaccard"] == 2
    assert counters["prefilter"] == dict(pf.STATS)
    assert set(counters) >= {"funnel", "prefilter", "gapdp", "coalesce",
                             "trace"}
    pf.reset_stats()
    assert pf.STATS["intervals"] == 0
    with pytest.raises(KeyError):
        pf.STATS.add("device_ms")


def test_counters_and_spans_lose_nothing_under_many_threads():
    """More threads than cores, a short switch interval: every add and
    every span of every thread is kept."""
    c = trace.Counters("stress", ("n",))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        def work(_):
            for _ in range(500):
                c.add("n")
                with trace.span("s"):
                    pass

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        trace.disable()
        trace._REGISTRY.pop("stress", None)
    assert c["n"] == 16 * 500
    assert len(trace.snapshot()["spans"]) == 16 * 500


# -- the paths -------------------------------------------------------------


def test_classify_pair_spans_add_up(monkeypatch):
    """Two generated pairs through ``classify_pair`` on a cpu aligner's
    Python region path: ``pair`` holds ``seed`` (with ``seed.index``) and
    ``region``, which holds the anchors, the chaining and the host's gap
    DPs; the parts and ``region``'s self time make up its duration."""
    monkeypatch.setenv("SEDEF_NATIVE_REGION", "0")
    al = wf.WavefrontAligner(device="cpu")
    rng = random.Random(7)
    pairs = [sim.generate_random_sd(rng, 10, min_len=1500, max_len=3000)
             for _ in range(2)]
    trace.enable()
    for s1, s2, _ in pairs:
        sim.classify_pair(s1, s2, 10, aligner=al)
    trace.disable()
    snap = trace.snapshot()
    spans = _by_name(snap)
    by_id = {s["id"]: s for s in snap["spans"]}
    assert len(spans["pair"]) == 2
    roots = {s["id"] for s in spans["pair"]}
    assert all(s["root"] in roots for s in snap["spans"])
    for name, parent in (("seed", "pair"), ("seed.index", "seed"),
                         ("region", "pair"), ("region.anchors", "region"),
                         ("region.chain", "region"),
                         ("gapdp.host", "region")):
        assert spans[name], name
        assert all(by_id[s["parent"]]["name"] == parent
                   for s in spans[name]), name
    assert all(s["attrs"] == {"route": "python"} for s in spans["region"])
    assert "gapdp.card" not in spans
    own = trace.self_times(snap)
    for r in spans["region"]:
        parts = sum(s["t1"] - s["t0"] for s in snap["spans"]
                    if s["parent"] == r["id"])
        assert parts + own[r["id"]] == pytest.approx(r["t1"] - r["t0"],
                                                     abs=1e-9)
        assert own[r["id"]] >= 0


def _problems():
    rng = np.random.default_rng(3)
    sizes = [(40, 50), (90, 70), (130, 128), (20, 20)]
    pairs = [(rng.integers(0, 4, n).astype(np.int8),
              rng.integers(0, 4, m).astype(np.int8)) for n, m in sizes]
    pairs += [(np.zeros(0, np.int8), np.zeros(3, np.int8)),
              (np.zeros(4, np.int8), np.zeros(0, np.int8))]
    return pairs, sum(n * m for n, m in sizes)


def test_gapdp_counters_by_route():
    """The router's counts equal the batch's problems and ql x tl cells,
    by route: host stragglers and degenerate problems at the frozen
    floors, the device route with both floors lowered."""
    pairs, cells = _problems()
    al = wf.WavefrontAligner(device="cpu")
    trace.enable()
    host = al.align_batch(pairs)
    c = wf.GAPDP.snapshot()
    assert c["problems.degenerate"] == 2 and c["problems.host"] == 4
    assert c["cells.host"] == cells
    assert c["problems.card"] == c["cells.card"] == 0
    assert all(c[f"groups.{r}"] == 0 for r in wf.ROUTES)
    wf.GAPDP.reset()
    al.DEVICE_BATCH_MIN = 1
    al.DEVICE_BATCH_MIN_CELLS = 0
    assert al.align_batch(pairs) == host
    trace.disable()
    c = wf.GAPDP.snapshot()
    assert c["problems.degenerate"] == 2 and c["problems.card"] == 4
    assert c["cells.card"] == cells and c["cells.host"] == 0
    # (128, 128) holds three problems, (256, 128) the fourth
    assert c["groups.direct"] == 2 == al.device_batches
    assert sum(c[f"groups.{r}"] for r in wf.ROUTES) == 2
    spans = _by_name(trace.snapshot())
    assert len(spans["gapdp.host"]) == 1 and len(spans["gapdp.card"]) == 1
    for name in ("gapdp.card.pack", "gapdp.card.upload", "gapdp.card.wait",
                 "gapdp.card.decode"):
        assert len(spans[name]) == 2, name
        assert all(s["parent"] == spans["gapdp.card"][0]["id"]
                   for s in spans[name]), name


def test_decode_runs_count_the_card_cigars_runs():
    """``decode.runs`` adds the runs of every CIGAR the card route
    decoded, and ``gapdp.card.decode`` is one span a launch group under
    ``gapdp.card``."""
    pairs, _ = _problems()
    al = wf.WavefrontAligner(device="cpu")
    al.DEVICE_BATCH_MIN = 1
    al.DEVICE_BATCH_MIN_CELLS = 0
    trace.enable()
    got = al.align_batch(pairs)
    trace.disable()
    snap = trace.snapshot()
    card = [cig for (q, t), cig in zip(pairs, got) if len(q) and len(t)]
    c = snap["counters"]["gapdp"]
    assert c["decode.runs"] == sum(len(cig) for cig in card) > len(card)
    spans = _by_name(snap)
    assert len(spans["gapdp.card"]) == 1
    assert len(spans["gapdp.card.decode"]) == al.device_batches == 2
    assert all(s["parent"] == spans["gapdp.card"][0]["id"]
               for s in spans["gapdp.card.decode"])


def test_region_counters_count_routes_anchors_chains_and_gaps(monkeypatch):
    """One small region with random flanks on each route: the ``region``
    counters are in the snapshot; on the Python route ``anchors`` is the
    scan's row count (every row lands in the chains' path), ``chained``
    the rows of the chains kept, and ``gaps`` the gaps their alignments
    plan, one fewer than a chain's rows."""
    from sedef_tpu_torch.io.bed import Hit, SeqRef
    from sedef_tpu_torch.models import aligner as region
    from sedef_tpu_torch.ops import cigar
    from sedef_tpu_torch.ops.anchors import generate_anchors
    from sedef_tpu_torch.ops.chain import chain_anchors
    rng = random.Random(11)
    s1, s2, _ = sim.generate_random_sd(rng, 10, min_len=2000, max_len=3000)
    q = sim.rand_seq(rng, 1500) + s1 + sim.rand_seq(rng, 1500)
    r = sim.rand_seq(rng, 1500) + s2 + sim.rand_seq(rng, 1500)
    orig = Hit(SeqRef("A", False, len(q)), 0, len(q),
               SeqRef("B", False, len(r)), 0, len(r))
    planned, stitched = [], []
    gap_jobs, many = cigar._gap_jobs, cigar.Alignment.from_anchors_many

    def record_gaps(qstr, rstr, qpe, *rest):
        planned.append(len(qpe))
        return gap_jobs(qstr, rstr, qpe, *rest)

    def record_chains(qstr, rstr, rows, starts, al=None):
        stitched.append((len(rows), len(starts) - 1))
        return many(qstr, rstr, rows, starts, al)

    monkeypatch.setattr(cigar, "_gap_jobs", record_gaps)
    monkeypatch.setattr(cigar.Alignment, "from_anchors_many", record_chains)
    al = wf.WavefrontAligner(device="cpu")
    monkeypatch.setenv("SEDEF_NATIVE_REGION", "0")
    hits = region.fast_align(q, r, orig, 11, aligner=al)
    c = trace.snapshot()["counters"]["region"]
    rows = generate_anchors(q, r, False, 0, 0, 11)
    path, _ = chain_anchors(rows)
    (chained, chains), = stitched
    assert hits and chains >= 1
    assert c["python"] == 1 and c["native"] == 0
    assert c["anchors"] == len(rows) == len(path)
    assert c["chained"] == chained and c["anchors"] > c["chained"] > 0
    assert c["gaps"] == planned[0] == chained - chains
    monkeypatch.setenv("SEDEF_NATIVE_REGION", "1")
    region.fast_align(q, r, orig, 11, aligner=al)
    c2 = trace.snapshot()["counters"]["region"]
    assert c2 == dict(c, native=1)


def test_launch_groups_hold_three_numbers_a_class():
    """``launch_groups`` keeps per (route, S_q, S_t) the groups, the
    problems summed and the most problems in one group, however many
    batches run."""
    pairs, _ = _problems()
    al = wf.WavefrontAligner(device="cpu")
    al.DEVICE_BATCH_MIN = 1
    al.DEVICE_BATCH_MIN_CELLS = 0
    for k in range(3):
        al.align_batch(pairs[:4 - k])
    # (130, 128) is the (256, 128) class's, the others (128, 128)'s
    assert al.launch_groups == {("direct", 128, 128): [3, 7, 3],
                                ("direct", 256, 128): [2, 2, 1]}


def test_coalescing_aligner_counts_its_rounds(monkeypatch):
    """On a card base the coalescing aligner sleeps its window in a
    ``coalesce.wait`` span and counts the round it dispatches (the base's
    device is faked; its batches go to the CPU's routes)."""
    base = wf.WavefrontAligner(device="cpu")
    monkeypatch.setattr(base, "device", torch.device("cuda", 0))
    monkeypatch.setattr(base, "_align_device", lambda *a: None)
    co = wf.CoalescingAligner(base, window_s=0.001)
    pairs, _ = _problems()
    trace.enable()
    with trace.span("region"):
        got = co.align_batch(pairs[:2])
    trace.disable()
    assert len(got) == 2 and all(got)
    assert wf.COALESCE["rounds"] == 1
    spans = _by_name(trace.snapshot())
    assert len(spans["coalesce.wait"]) == 1
    assert spans["coalesce.wait"][0]["t1"] - spans["coalesce.wait"][0][
        "t0"] >= 0.001


def _genome(tmp_path):
    """A 30 Kbp chromosome holding a 2.2 Kbp inverted duplication."""
    from sedef_tpu_torch.ops.dna import revcomp
    rng = np.random.default_rng(5)
    bg = rng.choice(np.array(list("acgt")), 24000)
    seg = "".join(rng.choice(np.array(list("ACGT")), 2200))
    chrom = ("".join(bg[:4000]) + seg + "".join(bg[4000:12000])
             + revcomp(seg) + "".join(bg[12000:]))
    fa = tmp_path / "inv.fa"
    with open(fa, "w") as f:
        f.write(">chrI\n")
        for i in range(0, len(chrom), 80):
            f.write(chrom[i:i + 80] + "\n")
    return str(fa)


def test_cli_pipeline_trace_spans_one_genome_across_threads(tmp_path):
    """``pipeline --trace PATH -j 2`` on the CPU writes one JSON snapshot:
    its stage-1 pair jobs, tail regions and tail stats, on more than one
    thread, all under one ``genome`` root; tracing is off again after."""
    from sedef_tpu_torch import cli
    out = tmp_path / "trace.json"
    t0 = time.perf_counter()
    rc = cli.main(["pipeline", _genome(tmp_path), "-o", str(tmp_path / "o"),
                   "-j", "2", "--device", "cpu", "--trace", str(out)])
    assert rc == 0 and trace.span("after") is trace.NOOP
    snap = json.loads(out.read_text())
    assert snap["clock"] == "perf_counter"
    spans = _by_name(snap)
    (genome,) = spans["genome"]
    assert t0 <= genome["t0"] <= genome["t1"] <= time.perf_counter()
    assert len(spans["search.job"]) == 2
    assert {(s["attrs"]["i"], s["attrs"]["j"], s["attrs"]["rc"])
            for s in spans["search.job"]} == {(0, 0, False), (0, 0, True)}
    assert spans["tail.region"] and spans["tail.stats"]
    assert spans["region"]
    assert all(s["root"] == genome["id"] for s in snap["spans"])
    assert len({s["thread"] for s in snap["spans"]}) > 1
    assert {s["thread"] for s in spans["tail.region"]}.isdisjoint(
        {genome["thread"]})
    assert snap["counters"]["funnel"]["total"] > 0
