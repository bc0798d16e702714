"""The port's stage-1 seed search (``sedef_tpu_torch.models``) against the
reference package's (``sedef_tpu.models``) and the golden seeds of
``tests/test_seeder.py`` (the reference search engine compiled from
search.cc / sliding.cc / filter.cc): the same FASTA through both
packages' ``search_job``, forward and reverse complement, a same-genome
pair, N runs and soft-masking, and ``report_fails``' diagnostics.  Runs
on the host route.  Tolerance: exact equality (BED rows byte for
byte)."""

import pathlib

import numpy as np
import pytest

from sedef_tpu.io.fasta import FastaReference as RefFasta
from sedef_tpu.models import pipeline as ref_pipeline
from sedef_tpu.models import seeder as ref_seeder
from sedef_tpu.ops import dna as ref_dna
from sedef_tpu.ops.index import MinimizerIndex as RefIndex
from sedef_tpu_torch.io.fasta import FastaReference
from sedef_tpu_torch.models import pipeline, seeder
from sedef_tpu_torch.ops import dna
from sedef_tpu_torch.ops.index import MinimizerIndex

FIX = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def multi():
    path = str(FIX / "search" / "multi.fa")
    return FastaReference(path), RefFasta(path)


@pytest.mark.parametrize("q,r,rc", [
    ("chr1", "chr1", False), ("chr1", "chr1", True),
    ("chr1", "chr2", False), ("chr1", "chr2", True),
    ("chr2", "chr2", False), ("chr2", "chr2", True),
])
def test_search_matches_reference_and_golden(multi, q, r, rc):
    golden = (FIX / "search" / f"seeds_{q}_{r}_{'rc' if rc else 'fwd'}.bed"
              ).read_text().splitlines()
    mine = pipeline.search_job(multi[0], [q], [r], rc, use_device=False)
    ref = ref_pipeline.search_job(multi[1], [q], [r], rc)
    assert mine == ref == golden


@pytest.mark.parametrize("rc", [False, True])
def test_search_toy_genome_matches_reference(rc):
    path = str(FIX / "stats" / "toy.fa")
    golden = (FIX / "stats" / f"toy_seeds_{'rc' if rc else 'fwd'}.bed"
              ).read_text().splitlines()
    mine = pipeline.search_job(FastaReference(path), ["chr1"], ["chr1"], rc,
                               use_device=False)
    ref = ref_pipeline.search_job(RefFasta(path), ["chr1"], ["chr1"], rc)
    assert mine == ref == golden


def test_report_fails_matches_reference():
    """``report_fails`` rows (the gate-failure comments of search.cc's
    fail hits) and the normal rows, equal between the packages."""
    rng = np.random.default_rng(3)
    base = "".join(rng.choice(np.array(list("ACGT")), 2500))
    mut = list(base)
    for i in range(len(mut)):
        if rng.random() < 0.2:
            mut[i] = "ACGT"[rng.integers(4)]
    chrom = (base + "".join(rng.choice(np.array(list("ACGT")), 2000))
             + "".join(mut))
    qh = MinimizerIndex(dna.PackedSeq("chrA", chrom), 12, 16)
    rqh = RefIndex(ref_dna.PackedSeq("chrA", chrom), 12, 16)
    for fails in (True, False):
        mine = seeder.initial_search(qh, qh, True, report_fails=fails,
                                     use_device=False)
        ref = ref_seeder.initial_search(rqh, rqh, True, report_fails=fails)
        assert [(h.to_bed(), h.comment) for h in mine] == \
            [(h.to_bed(), h.comment) for h in ref]
        if fails:
            assert any(h.comment.startswith("jaccard") for h in mine)
