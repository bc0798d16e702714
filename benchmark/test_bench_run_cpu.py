"""The rest of a run on the CPU: the harness's look for a card skipped, the
program on its host route (with the card route's region path, so that its
gap DPs go through the aligner) at a size a test holds.  Sound, a run
reports correct with the contract's keys; with the timed path broken
underneath, correct comes out false, once for each fault the cells can have
(neither has a training state or an exchange between chips): half of the
work left out, and an answer altered where it is produced; and under the
control, an approximate gap DP."""

import pytest

import run as bench_run
from harness import loader

# genome-dense is held back in pending/ (PERF.md): its code stays tested
pytestmark = pytest.mark.usefixtures("with_pending")

SEED = 2**33 + 101


def tiny(cell: str) -> dict:
    t = loader.traffic(cell)
    if cell == "genome-dense":
        t["recipe"] = dict(t["recipe"], length=1_200_000, n_sds=10,
                           repeat_families=4)
        t["pool"], t["check_genomes"] = 1, 1
    else:
        t["pool"], t["check_pairs"] = 10, 6
        t["max_len"] = 30_000
    return t


def _run(cell: str, monkeypatch, plant=None) -> dict:
    monkeypatch.setenv("SEDEF_NATIVE_REGION", "0")
    return bench_run.run(cell, SEED, 1.0, False, device="cpu",
                         traffic=tiny(cell), plant=plant)


@pytest.mark.parametrize("cell", ["genome-dense", "pairs-rand"])
def test_sound_run_is_correct_with_the_contract_keys(cell, monkeypatch):
    out = _run(cell, monkeypatch)
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
