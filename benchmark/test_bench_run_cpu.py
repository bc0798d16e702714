"""The rest of a run on the CPU: the harness's look for a card skipped, the
program on its host route (with the card route's region path, so that its
gap DPs go through the aligner) at a size a test holds.  Sound, a run
reports correct with the contract's keys; with the timed path broken
underneath, correct comes out false, once for each fault the cells can have
(no cell has a training state or an exchange between chips): half of the
work left out, and an answer altered where it is produced; and under the
control, an approximate gap DP."""

import time

import pytest

import run as bench_run
from harness import loader
from harness import trace as harness_trace

# genome-dense is held back in pending/ (PERF.md): its code stays tested
pytestmark = pytest.mark.usefixtures("with_pending")

SEED = 2**33 + 101


def tiny(cell: str) -> dict:
    t = loader.traffic(cell)
    if cell == "genome-dense":
        t["recipe"] = dict(t["recipe"], length=1_200_000, n_sds=10,
                           repeat_families=4)
        t["pool"], t["check_genomes"] = 1, 1
    elif cell == "genome-mosaic":
        # the small-core class only, and N-runs at a spacing the short
        # chromosomes hold: on the CPU every gap DP takes the host route,
        # where the 10 Kbp class's would take seconds each.  The coverage
        # reads the reverse SDs and the mosaics' conserved blocks, and
        # stage 1 gives each reverse SD one seed row over its length: four
        # SDs, half of them reverse, give the half faults some to leave out.
        t["recipe"] = dict(t["recipe"], length=1_200_000, n_sds=4,
                           sd_min=30_000, sd_max=40_000,
                           n_run_every=199_000, repeat_families=1,
                           rc_fraction=0.5)
        small = t["mosaic"]["cores"][1], t["mosaic"]["keeps"][1]
        t["mosaic"] = {"cores": [small[0]] * 2, "keeps": [small[1]] * 2}
        # the recipe's own draws: at this size ``sizes_seed`` puts both
        # reverse SDs on one chromosome, under one reverse seed row that
        # the half-seeds fault keeps
        del t["sizes_seed"]
        t["pool"], t["check_genomes"] = 1, 1
    else:
        t["pool"], t["check_pairs"] = 10, 6
        t["max_len"] = 30_000
    return t


def _run(cell: str, monkeypatch, plant=None) -> dict:
    monkeypatch.setenv("SEDEF_NATIVE_REGION", "0")
    return bench_run.run(cell, SEED, 1.0, False, device="cpu",
                         traffic=tiny(cell), plant=plant)


@pytest.mark.parametrize("cell", ["genome-dense", "genome-mosaic",
                                  "pairs-rand"])
def test_sound_run_is_correct_with_the_contract_keys(cell, monkeypatch):
    from sedef_tpu_torch import trace
    trace.reset()
    out = _run(cell, monkeypatch)
    # an untraced run leaves the program's trace off: no span recorded
    assert trace.span("x") is trace.NOOP
    assert trace.snapshot()["spans"] == []
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["gapdps_checked"]["value"] > 100
    e2e, _ = loader.cell_metrics(loader.manifest(), cell)
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "op", "limit"}
               for c in out["checks"].values())


@pytest.mark.parametrize("cell,plant,number", [
    ("genome-dense", "control", "gapdp_suboptimal"),
    ("genome-dense", "half_seeds", "seed_missed_pct"),
    ("genome-dense", "half_regions", "final_missed_pct"),
    ("genome-dense", "altered", "aligned_rows_unsound"),
    ("genome-dense", "altered", "final_rows_unsound"),
    ("genome-mosaic", "control", "gapdp_suboptimal"),
    ("genome-mosaic", "half_seeds", "seed_missed_pct"),
    ("genome-mosaic", "half_regions", "final_missed_pct"),
    ("genome-mosaic", "altered", "aligned_rows_unsound"),
    ("genome-mosaic", "altered", "final_rows_unsound"),
    ("pairs-rand", "control", "gapdp_suboptimal"),
    ("pairs-rand", "half_pairs", "chain_missed_pct"),
    ("pairs-rand", "altered", "chain_hits_unsound"),
])
def test_broken_timed_path_is_not_correct(cell, plant, number, monkeypatch):
    out = _run(cell, monkeypatch, plant)
    assert out["correct"] is False, out["checks"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


def test_plants_are_undone(monkeypatch):
    """A planted run leaves the program as it found it."""
    from sedef_tpu_torch.models import pipeline
    before = (pipeline.search_stage, pipeline.align_stage,
              pipeline.OverlappedTail._submit_bin)
    _run("genome-dense", monkeypatch, "half_seeds")
    assert before == (pipeline.search_stage, pipeline.align_stage,
                      pipeline.OverlappedTail._submit_bin)


class _HostTrace:
    """The device trace's stand-in where there is no card: no activity, and
    an idle gap of 50 ms every 100 ms of the window, for the names."""

    def __init__(self, torch):
        self.kernels, self.busy_s, self.offset = [], 0.0, 0.0

    def __enter__(self):
        self.h0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self.h0
        self.gaps = [(self.h0 + i / 10, self.h0 + i / 10 + 0.05)
                     for i in range(int(self.window_s * 10))]

    def device_ops(self):
        return []

    idle_gaps = harness_trace.DeviceTrace.idle_gaps


# their spans open only around a wait for a card: the prefilter's or the
# roll engine's records (stage 1's engines stay on the host for a ``cpu``
# aligner), a coalescing round (a host aligner dispatches at once)
CARD_ONLY = {"seed_wait.ms_per_pair", "seed_wait.ms_per_genome",
             "coalesce_wait.ms_per_genome"}


@pytest.mark.parametrize("cell", ["genome-mosaic", "pairs-rand"])
def test_traced_run_reads_the_programs_spans_and_counters(cell, monkeypatch):
    """A traced run on the CPU, the device trace stood in for: the readers
    get the window's program trace as ``ctx["program"]``, every metric of
    the cell that reads the program's spans or counters gives a number
    (but those whose spans need a card: None), the idle gaps name program
    spans, and the program's trace is off again after the window."""
    from sedef_tpu_torch import trace
    from sedef_tpu_torch.ops.wavefront import WavefrontAligner
    monkeypatch.setattr(harness_trace, "DeviceTrace", _HostTrace)
    if cell == "pairs-rand":
        # a pair's gap-DP batches are under the floors: send the larger
        # ones to the card route's plain versions, for its spans and
        # counters (a genome's reach it at the floors)
        monkeypatch.setattr(WavefrontAligner, "DEVICE_BATCH_MIN", 1)
        monkeypatch.setattr(WavefrontAligner, "DEVICE_BATCH_MIN_CELLS",
                            20_000)
    ctxs = []
    metric = loader.metric

    def recording(name):
        mod = metric(name)

        class Reader:
            SOURCE = mod.SOURCE

            @staticmethod
            def read(ctx):
                ctxs.append(ctx)
                return mod.read(ctx)
        return Reader
    monkeypatch.setattr(loader, "metric", recording)
    monkeypatch.setenv("SEDEF_NATIVE_REGION", "0")
    out = bench_run.run(cell, SEED, 1.0, True, device="cpu",
                        traffic=tiny(cell))
    assert out["correct"] is True, out["checks"]
    assert trace.span("x") is trace.NOOP
    snap = ctxs[0]["program"]
    assert snap["spans"] and snap["counters"]["trace"]["dropped"] == 0
    assert snap["counters"]["gapdp"]["problems.card"] > 0
    _, layer = loader.cell_metrics(loader.manifest(), cell)
    program = [m["name"] for m in layer
               if m["source"] in ("program_span", "program_counter")]
    assert set(CARD_ONLY) & set(program)
    for name in program:
        v = metric(name).read(ctxs[0])
        if name in CARD_ONLY:
            assert v is None, name
        else:
            assert isinstance(v, float) and v > 0, (name, v)
            assert out["metrics"][name]["value"] == v
    assert any(" > " in name for name, _ in out["breakdown"]["idle_gaps"])
