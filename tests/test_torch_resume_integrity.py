"""Crash-consistency of the port's resumable drivers: tests/
test_resume_integrity.py's cases, run against the port's resume helpers
and against both ``run_pipeline`` and ``run_pipeline_distributed`` (in
single-process mode), with every resumed output byte-identical to a fresh
run's."""

import os

import pytest
import torch

from sedef_tpu_torch.models.pipeline import run_pipeline
from sedef_tpu_torch.ops.wavefront import WavefrontAligner
from sedef_tpu_torch.parallel.distributed import (guard_nonempty,
                                                  manifest_of, ok_valid,
                                                  run_pipeline_distributed,
                                                  wipe_stage, write_ok)

from test_resume_integrity import _mk, _planted_genome

torch.set_num_threads(1)

DRIVERS = {"run_pipeline": run_pipeline,
           "run_pipeline_distributed": run_pipeline_distributed}


def test_manifest_roundtrip(tmp_path):
    art = _mk(tmp_path, "a.bed", "r1\nr2\nr3\n")
    ok = str(tmp_path / "a.ok")
    write_ok(ok, art)
    assert manifest_of(art)["rows"] == 3
    assert ok_valid(ok, art)
    open(art, "w").write("r1\n")
    assert not ok_valid(ok, art)
    open(art, "w").write("r1\nr2\nrX\n")  # same size: the CRC decides
    assert not ok_valid(ok, art)


def test_legacy_empty_sentinel_is_invalid(tmp_path):
    art = _mk(tmp_path, "a.bed", "r1\n")
    ok = str(tmp_path / "a.ok")
    open(ok, "w").close()
    assert not ok_valid(ok, art)


def test_missing_artifact_is_invalid(tmp_path):
    art = _mk(tmp_path, "a.bed", "r1\n")
    ok = str(tmp_path / "a.ok")
    write_ok(ok, art)
    os.unlink(art)
    assert not ok_valid(ok, art)


def test_guard_nonempty(monkeypatch):
    guard_nonempty("x", 5, 10)
    guard_nonempty("x", 0, 0)
    with pytest.raises(RuntimeError, match="0 rows from 10"):
        guard_nonempty("x", 0, 10)
    monkeypatch.setenv("SEDEF_ALLOW_EMPTY", "1")
    guard_nonempty("x", 0, 10)


def test_wipe_stage_scopes_to_pid(tmp_path):
    art = _mk(tmp_path, "seeds.bed", "r\n")
    _mk(tmp_path, "seeds.ok", "{}")
    _mk(tmp_path, "seeds.bed.tmp.0", "partial")
    _mk(tmp_path, "seeds.spool.0", "spool")
    _mk(tmp_path, "seeds.spool.1", "other live process")
    wipe_stage(str(tmp_path), "seeds", [art], pid=0)
    assert not os.path.exists(art)
    assert not (tmp_path / "seeds.ok").exists()
    assert not (tmp_path / "seeds.bed.tmp.0").exists()
    assert not (tmp_path / "seeds.spool.0").exists()
    assert (tmp_path / "seeds.spool.1").exists()


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_poisoned_resume_recovers(tmp_path, driver):
    """A dead attempt left an EMPTY aligned.bed with a contentless
    sentinel: the resume detects the poison, reruns the align stage and
    writes the fresh run's final.bed."""
    run = DRIVERS[driver]
    fa = _planted_genome(tmp_path)
    al = WavefrontAligner(device="cpu")
    ref = run_pipeline(fa, str(tmp_path / "ref"), nbuckets=2, aligner=al)
    ref_final = open(ref["final"]).read()
    assert len(ref_final.splitlines()) >= 2

    out = tmp_path / "out"
    run(fa, str(out), nbuckets=2, aligner=al)
    open(out / "aligned.bed", "w").close()
    open(out / "aligned.ok", "w").close()
    os.unlink(out / "final.bed")
    os.unlink(out / "final.ok")
    paths = run(fa, str(out), nbuckets=2, aligner=al)
    assert open(paths["final"]).read() == ref_final


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_self_consistent_empty_artifact_refused(tmp_path, driver):
    """A sentinel whose manifest matches an empty aligned.bed is refused
    at resume: the empty-from-nonempty audit fires."""
    run = DRIVERS[driver]
    fa = _planted_genome(tmp_path)
    al = WavefrontAligner(device="cpu")
    out = tmp_path / "out"
    run(fa, str(out), nbuckets=2, aligner=al)
    open(out / "aligned.bed", "w").close()
    write_ok(str(out / "aligned.ok"), str(out / "aligned.bed"))
    os.unlink(out / "final.bed")
    os.unlink(out / "final.ok")
    with pytest.raises(RuntimeError, match="align \\(resumed\\)"):
        run(fa, str(out), nbuckets=2, aligner=al)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_truncated_seeds_rerun_byte_identical(tmp_path, driver):
    """Truncating seeds.bed after a complete run invalidates its manifest;
    the resume rebuilds stage 1 and the restored file is byte-identical."""
    run = DRIVERS[driver]
    fa = _planted_genome(tmp_path)
    al = WavefrontAligner(device="cpu")
    out = tmp_path / "out"
    paths = run(fa, str(out), nbuckets=2, aligner=al)
    seeds_before = open(paths["seeds"]).read()
    final_before = open(paths["final"]).read()
    with open(paths["seeds"], "w") as f:
        f.write(seeds_before[:len(seeds_before) // 2])
    paths = run(fa, str(out), nbuckets=2, aligner=al, force=False)
    assert open(paths["seeds"]).read() == seeds_before
    assert open(paths["final"]).read() == final_before
