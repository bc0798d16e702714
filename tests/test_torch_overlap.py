"""The port's cross-stage overlap (``run_pipeline``'s ``OverlappedTail``)
under ``tests/test_overlap.py``'s cases, held against the reference
package: the overlapped run's seeds / aligned / final beds equal the
sequential stage structure's and ``sedef_tpu``'s on the same genome, and
a completed overlapped run resumes to the same final.bed.  Tolerance:
byte equality."""

import numpy as np
import pytest
import torch

from sedef_tpu.models.genome_sim import simulate_genome as ref_simulate
from sedef_tpu.models.pipeline import run_pipeline as ref_run_pipeline
from sedef_tpu.ops.wavefront import WavefrontAligner as RefAligner
from sedef_tpu_torch.models.genome_sim import simulate_genome, write_fasta
from sedef_tpu_torch.models.pipeline import run_pipeline
from sedef_tpu_torch.ops.wavefront import WavefrontAligner

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,n_chroms", [(41, 3), (42, 1)])
def test_overlapped_equals_sequential(tmp_path, monkeypatch, seed,
                                      n_chroms):
    kw = dict(sd_min=1500, sd_max=5000, seed=seed, n_chroms=n_chroms,
              repeat_families=2, repeat_copies=6)
    chroms, _ = simulate_genome(600_000, 6, **kw)
    assert chroms == ref_simulate(600_000, 6, **kw)[0]
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, chroms)
    al = WavefrontAligner(device="cpu")

    monkeypatch.delenv("SEDEF_NO_OVERLAP", raising=False)
    ov = run_pipeline(fa, str(tmp_path / "ov"), nbuckets=3, aligner=al,
                      jobs=2)
    ref = ref_run_pipeline(fa, str(tmp_path / "ref"), nbuckets=3,
                           aligner=RefAligner(use_tpu=False), jobs=2)
    monkeypatch.setenv("SEDEF_NO_OVERLAP", "1")
    sq = run_pipeline(fa, str(tmp_path / "sq"), nbuckets=3, aligner=al,
                      jobs=2)
    for k in ("seeds", "aligned", "final"):
        got = open(ov[k]).read()
        assert got == open(sq[k]).read(), k
        assert got == open(ref[k]).read(), k
    assert len(open(ov["final"]).read().splitlines()) >= 2


def test_overlapped_resume_uses_sequential_path(tmp_path, monkeypatch):
    """After a completed overlapped run, artifacts resume cleanly (the
    overlapped tail writes the manifests the sequential path validates),
    and final.bed is the reference package's."""
    rng = np.random.default_rng(57)
    bg = rng.choice(np.array(list("acgt")), 15000)
    seg = "".join(rng.choice(np.array(list("ACGT")), 1500))
    chrom = ("".join(bg[:3000]) + seg + "".join(bg[3000:9000]) + seg
             + "".join(bg[9000:]))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(">chrO\n")
        for i in range(0, len(chrom), 70):
            f.write(chrom[i:i + 70] + "\n")
    al = WavefrontAligner(device="cpu")
    monkeypatch.delenv("SEDEF_NO_OVERLAP", raising=False)
    p1 = run_pipeline(str(fa), str(tmp_path / "out"), nbuckets=2,
                      aligner=al)
    before = open(p1["final"]).read()
    assert before.splitlines()[1:]
    p2 = run_pipeline(str(fa), str(tmp_path / "out"), nbuckets=2,
                      aligner=al)  # full resume, no recompute
    assert open(p2["final"]).read() == before
    ref = ref_run_pipeline(str(fa), str(tmp_path / "ref"), nbuckets=2,
                           aligner=RefAligner(use_tpu=False))
    assert open(ref["final"]).read() == before
