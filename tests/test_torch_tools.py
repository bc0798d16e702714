"""The port's scale and accuracy harnesses (``sedef_tpu_torch/tools/
rehearsal.py``, ``accuracy_table.py``, ``perf_pipeline.py``) against the
reference package's tools under ``tools/``: the same genome arguments and
FASTA bytes for both rehearsal recipes, the same three beds from both
packages' ``run_pipeline`` on the dense genome, the same accuracy rows,
and the report's fields.  Tolerance: exact equality (bytes, rows,
counts)."""

import importlib.util
import inspect
import json
import os
import pathlib
import sys

import pytest
import torch

from sedef_tpu.io.fasta import write_fai as ref_write_fai
from sedef_tpu.models import genome_sim as ref_gs
from sedef_tpu.models.pipeline import run_pipeline as ref_run_pipeline
from sedef_tpu.ops.wavefront import WavefrontAligner as RefAligner
from sedef_tpu_torch.ops import wavefront as wf
from sedef_tpu_torch.tools import accuracy_table, perf_pipeline, rehearsal

torch.set_num_threads(1)

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
MBP = 2


def _load_tool(name, monkeypatch):
    """The reference tool ``tools/<name>.py`` as a module (its import-time
    environment default undone after the test)."""
    monkeypatch.delenv("SEDEF_INDEX_CACHE_GB", raising=False)
    monkeypatch.syspath_prepend(str(TOOLS))
    spec = importlib.util.spec_from_file_location(f"ref_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Called(Exception):
    pass


def _spy_simulate_genome(monkeypatch):
    """Make the reference's ``simulate_genome`` stop its caller, keeping
    the keyword form of the arguments it was called with."""
    sig = inspect.signature(ref_gs.simulate_genome)

    def spy(*args, **kwargs):
        raise _Called(dict(sig.bind(*args, **kwargs).arguments))

    monkeypatch.setattr(ref_gs, "simulate_genome", spy)


def _reference_tool_kwargs(recipe, mbp, tmp_path, monkeypatch,
                           n_chroms=None):
    """The ``simulate_genome`` arguments the reference tool of ``recipe``
    gives at ``mbp`` Mbp (``dense_parity`` when ``n_chroms`` is 2)."""
    _spy_simulate_genome(monkeypatch)
    if recipe == "dense" and n_chroms == 2:
        tool = _load_tool("dense_parity", monkeypatch)
        monkeypatch.setattr(sys, "argv", ["dense_parity.py",
                                          f"--mbp={mbp}"])
        monkeypatch.setattr("tempfile.mkdtemp",
                            lambda prefix="": str(tmp_path))
        call = tool.main
    elif recipe == "dense":
        tool = _load_tool("hg19_dense_rehearsal", monkeypatch)
        monkeypatch.setattr(tool, "WORK", str(tmp_path))
        call = lambda: tool.generate(mbp / 1000, True)  # noqa: E731
    else:
        tool = _load_tool("hg19_rehearsal", monkeypatch)
        monkeypatch.setattr(tool, "WORK", str(tmp_path))
        call = lambda: tool.generate(mbp / 1000, n_chroms, True)  # noqa
    with pytest.raises(_Called) as got:
        call()
    return got.value.args[0]


@pytest.mark.parametrize("recipe, mbp, n_chroms", [
    ("dense", 3000, None), ("dense", 100, 2), ("dense", MBP, None),
    ("sparse", 3000, 24), ("sparse", MBP, 2)])
def test_recipes_give_the_reference_tools_arguments(recipe, mbp, n_chroms,
                                                    tmp_path, monkeypatch):
    want = _reference_tool_kwargs(recipe, mbp, tmp_path, monkeypatch,
                                  n_chroms)
    assert rehearsal.recipe_kwargs(recipe, mbp * 1_000_000,
                                   n_chroms) == want


def test_dense_spec_names_the_recorded_genome():
    assert rehearsal.spec_of("dense", 100, 2) == (
        "sim(100Mbp,2chr,dense:fams300x90,seed1905)")


@pytest.mark.parametrize("recipe, n_chroms", [("dense", None),
                                              ("sparse", 2)])
def test_recipe_fasta_bytes_equal_the_reference(recipe, n_chroms,
                                                tmp_path):
    """The recipe's genome at 2 Mbp, written by the port's tool, against
    the reference's ``simulate_genome`` with its tool's arguments (the
    sparse recipe's 25,000 SDs and 12,500 repeat copies are placed at any
    size, most of them in vain at 2 Mbp: ~40 s a package)."""
    fa, planted = rehearsal.generate(recipe, MBP, str(tmp_path / "port"),
                                     n_chroms)
    kw = rehearsal.recipe_kwargs(recipe, MBP * 1_000_000, n_chroms)
    chroms, ref_planted = ref_gs.simulate_genome(**kw)
    ref_fa = tmp_path / "ref.fa"
    ref_gs.write_fasta(str(ref_fa), chroms)
    ref_write_fai(str(ref_fa))
    assert open(fa, "rb").read() == ref_fa.read_bytes()
    assert open(fa + ".fai", "rb").read() == (
        pathlib.Path(str(ref_fa) + ".fai").read_bytes())
    assert planted == len(ref_planted)


@pytest.fixture(scope="module")
def dense_genome(tmp_path_factory):
    work = tmp_path_factory.mktemp("dense")
    return rehearsal.generate("dense", MBP, str(work))[0]


def test_dense_pipeline_beds_equal_the_reference(dense_genome, tmp_path):
    """``run_pipeline`` of both packages on the 2 Mbp dense genome, on the
    CPU (the port's through the rehearsal's host route), jobs 2, 16
    buckets: seeds.bed, aligned.bed and final.bed byte-equal."""
    fields, paths = rehearsal.run(dense_genome, str(tmp_path / "port"),
                                  rehearsal.make_aligner("cpu"), jobs=2,
                                  nbuckets=16)
    ref = ref_run_pipeline(dense_genome, str(tmp_path / "ref"), nbuckets=16,
                           aligner=RefAligner(use_tpu=False), jobs=2,
                           force=True)
    for stage in ("seeds", "aligned", "final"):
        assert open(paths[stage], "rb").read() == \
            open(ref[stage], "rb").read(), stage
        assert fields["rows"][stage] > 0
    assert fields["seeds_per_kbp"] == fields["rows"]["seeds"] / 2000


def test_rehearsal_report_fields_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``main --device cpu`` writes the reference report's fields and the
    port's device fields, the card's null."""
    monkeypatch.delenv("SEDEF_INDEX_CACHE_GB", raising=False)  # main sets it
    work = tmp_path / "work"
    assert rehearsal.main(["--mbp", "1", "--chroms", "2", "--nbuckets", "8",
                           "--device", "cpu", "--work", str(work)]) == 0
    report = json.loads((work / "report.json").read_text())
    assert json.loads(capsys.readouterr().out) == report
    assert set(report) == {
        "spec", "planted", "genome_s", "jobs", "nbuckets", "wall_s",
        "stage_s", "rows", "seeds_per_kbp", "device", "card",
        "device_problems", "device_cells", "device_batches", "launches"}
    assert report["spec"] == "sim(1Mbp,2chr,dense:fams3x90,seed1905)"
    assert report["device"] == "cpu" and report["card"] is None
    assert report["device_problems"] == report["device_batches"] == 0
    assert report["launches"] == {w.__name__: 0
                                  for w in wf.KERNEL_WRAPPERS}
    assert set(report["rows"]) >= {"seeds", "aligned", "final"}
    assert set(report["stage_s"]) <= set(rehearsal.STAGES)
    assert report["wall_s"] > 0
    # the genome of that spec is reused
    assert rehearsal.generate("dense", 1, str(work), 2)[1] == \
        report["planted"]


def test_rehearsal_removes_its_temporary_work(tmp_path, monkeypatch):
    monkeypatch.delenv("SEDEF_INDEX_CACHE_GB", raising=False)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    assert rehearsal.main(["--mbp", "0.5", "--chroms", "2", "--nbuckets",
                           "4", "--device", "cpu"]) == 0
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("error", [0, 15])
def test_accuracy_one_rate_equals_the_reference_tool(error, monkeypatch):
    ref_tool = _load_tool("accuracy_table", monkeypatch)
    want = ref_tool.one_rate((error, 2, 4000, False, False))
    assert accuracy_table.one_rate((error, 2, 4000, False, "cpu")) == want


def test_accuracy_table_rows_and_order(capsys):
    """The reference tool's rate order and row format, one process."""
    assert accuracy_table.rate_order(4) == [0, 4, 1, 3, 2]
    assert accuracy_table.rate_order(30)[:4] == [0, 30, 1, 29]
    assert accuracy_table.main(["1", "1", "1500", "--jobs", "1",
                                "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "error;hits;misses;partials"
    assert [int(ln.split(";")[0]) for ln in lines[1:]] == [0, 1]
    for ln in lines[1:]:
        assert sum(int(x) for x in ln.split(";")[1:]) == 1


def test_perf_pipeline_reports_stages_and_recall(capsys):
    assert perf_pipeline.main(["600000", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for tag in ("stage1 search", "stage2a bucket", "stage2b align",
                "stage3 stats", "recall: "):
        assert tag in out, out
    assert "0 problems on cpu" in out
