"""The port's WGAC evaluation (``models/evaluate.py``, ``stats diff``,
``check-overlap`` and ``pipeline -W``) against the reference package on
the same inputs.  Tolerance: equal result fields and byte-equal reports."""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest
import torch

from sedef_tpu.io.fasta import FastaReference as RefFastaReference
from sedef_tpu.models import evaluate as ref_ev
from sedef_tpu_torch.io.fasta import FastaReference
from sedef_tpu_torch.models import evaluate as ev

from test_evaluate import _wgac_row

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# WGAC truth approximating the two planted pairs of the toy genome, plus a
# fabricated pair nothing covers, a duplicate and an alt-contig row
WGAC = ["header",
        _wgac_row("chr1", 5000, 8000, "+", "chr1", 18000, 21150, "sd1"),
        _wgac_row("chr1", 5000, 8000, "-", "chr1", 31150, 34150, "sd2"),
        _wgac_row("chr1", 40000, 42000, "+", "chr1", 44000, 46000,
                  "missing_sd"),
        _wgac_row("chr1", 5000, 8000, "+", "chr1", 18000, 21150, "sd1"),
        _wgac_row("chr1", 7000, 9000, "+", "chr1", 19500, 21000, "part"),
        _wgac_row("chr1_alt1", 100, 900, "+", "chr1", 100, 900, "alt")]


def _final(fixtures_dir):
    return (fixtures_dir / "stats" / "final_golden.txt"
            ).read_text().splitlines()


def test_diff_and_overlap(fixtures_dir):
    """tests/test_evaluate.py's checks, through the port."""
    fr = FastaReference(str(fixtures_dir / "stats" / "toy.fa"))
    final = _final(fixtures_dir)
    res = ev.diff(fr, final[1:], WGAC[:4])
    assert res.sedef_span > 0 and res.wgac_span > 0
    assert res.intersect > 0.8 * res.sedef_span
    assert res.wgac_only >= 3500
    ov = ev.check_overlap(final[1:], WGAC[:4])
    assert ov.full >= 1
    assert ov.missed == 1
    assert ov.full + ov.partial + ov.missed == 3


@pytest.mark.parametrize("min_upper,min_coverage", [(100, 0.8), (2000, 0.95),
                                                    (0, 0.5)])
def test_results_match_reference(fixtures_dir, min_upper, min_coverage):
    """Every field of DiffResult / OverlapResult, and both reports, equal
    to the reference's on the same rows."""
    fa = str(fixtures_dir / "stats" / "toy.fa")
    final = _final(fixtures_dir)
    got = ev.diff(FastaReference(fa), final[1:], WGAC, min_upper)
    want = ref_ev.diff(RefFastaReference(fa), final[1:], WGAC, min_upper)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.report() == want.report()
    got = ev.check_overlap(final[1:], WGAC, min_coverage)
    want = ref_ev.check_overlap(final[1:], WGAC, min_coverage)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.report() == want.report()


_NO_REFERENCE = (
    "assert 'jax' not in sys.modules\n"
    "assert not any(m == 'sedef_tpu' or m.startswith('sedef_tpu.')"
    " for m in sys.modules)\n")


def _cli(pkg, args, cwd):
    """Run ``python -m <pkg>.cli args``; for the port, also check that it
    imported neither jax nor the reference package.  Returns stderr with
    the banner line (which names the package) dropped."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['{pkg}.cli'] + {list(args)!r}\n"
            "try:\n"
            f"    runpy.run_module('{pkg}.cli', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            + (_NO_REFERENCE if pkg == "sedef_tpu_torch" else ""))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(cwd), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stderr.splitlines(keepends=True)
    assert lines[0].startswith(("sedef-tpu ", "sedef-tpu-torch "))
    return "".join(lines[1:])


def test_cli_diff_and_check_overlap(fixtures_dir, tmp_path):
    """``stats diff`` and ``check-overlap`` print the reference's reports
    byte for byte, and the port imports no jax."""
    fa = str(fixtures_dir / "stats" / "toy.fa")
    bed = str(fixtures_dir / "stats" / "final_golden.txt")
    wgac = tmp_path / "wgac.tab"
    wgac.write_text("\n".join(WGAC) + "\n")
    for args in (["stats", "diff", fa, bed, str(wgac)],
                 ["check-overlap", str(wgac), bed]):
        got = _cli("sedef_tpu_torch", args, tmp_path)
        assert got == _cli("sedef_tpu", args, tmp_path), args
        assert got.strip()


def test_cli_pipeline_wgac(fixtures_dir, tmp_path):
    """``pipeline --device cpu -W``: wgac.report and the stderr report
    byte-equal to the reference CLI's."""
    shutil.copy(fixtures_dir / "stats" / "toy.fa", tmp_path / "toy.fa")
    wgac = tmp_path / "wgac.tab"
    wgac.write_text("\n".join(WGAC) + "\n")
    fa = str(tmp_path / "toy.fa")
    outs = {}
    for pkg, extra in (("sedef_tpu_torch", ["--device", "cpu"]),
                       ("sedef_tpu", [])):
        out = str(tmp_path / pkg)
        err = _cli(pkg, ["pipeline", fa, "-o", out, "-W", str(wgac)]
                   + extra, tmp_path)
        report = open(os.path.join(out, "wgac.report")).read()
        assert err.endswith(report)
        outs[pkg] = (report, open(os.path.join(out, "final.bed")).read())
    assert outs["sedef_tpu_torch"] == outs["sedef_tpu"]
    assert "WGAC SDs: 5" in outs["sedef_tpu"][0]
