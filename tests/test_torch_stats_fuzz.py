"""The port's stage 3 (``models/reporter.stats_rows``) under
``tests/test_stats_fuzz.py``'s randomized genomes, held against the
reference package in place of the compiled reference binary: random
planted-duplication genomes with N-runs flow through the port's search /
bucket / align stages, whose aligned rows must equal ``sedef_tpu``'s, and
both reporters process the same rows (subhit, split_alignment, canonical
swap, JC-K2P columns).  Tolerance: exact equality of the rows."""

import pytest
import torch

from sedef_tpu.config import DEFAULT as REF_DEFAULT
from sedef_tpu.io.fasta import FastaReference as RefFastaReference
from sedef_tpu.io.fasta import generate_translation as ref_translation
from sedef_tpu.models import pipeline as ref_pl
from sedef_tpu.models import reporter as ref_reporter
from sedef_tpu.ops.wavefront import WavefrontAligner as RefAligner
from sedef_tpu_torch.config import DEFAULT
from sedef_tpu_torch.io.fasta import (FastaReference, generate_translation,
                                      write_fai)
from sedef_tpu_torch.models import pipeline as pl
from sedef_tpu_torch.models import reporter
from sedef_tpu_torch.models.genome_sim import simulate_genome, write_fasta
from sedef_tpu_torch.ops.wavefront import WavefrontAligner

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_stats_rows_fuzz_vs_reference(tmp_path, seed):
    chroms, _ = simulate_genome(900_000, 8, sd_min=1500, sd_max=9000,
                                seed=seed, n_chroms=2,
                                n_run_every=120_000,
                                repeat_families=3, repeat_copies=8,
                                repeat_div=(0.05, 0.25))
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, chroms)
    write_fai(fa)
    fr = FastaReference(fa)
    bins = generate_translation(fr)
    seeds = pl.search_stage(fr, bins, DEFAULT, use_device=False)
    buckets = pl.bucket_stage(seeds, fr, bins, 4, DEFAULT)
    flat = [line for b in buckets for line in b]
    aligned = pl.canonical_sort_uniq(pl.align_stage(
        flat, fr, DEFAULT, WavefrontAligner(device="cpu")))
    assert len(aligned) >= 8, "fuzz genome produced too few alignments"

    rfr = RefFastaReference(fa)
    rbins = ref_translation(rfr)
    ref_seeds = ref_pl.search_stage(rfr, rbins, REF_DEFAULT,
                                    use_device=False)
    assert seeds == ref_seeds
    ref_buckets = ref_pl.bucket_stage(ref_seeds, rfr, rbins, 4, REF_DEFAULT)
    assert buckets == ref_buckets
    ref_aligned = ref_pl.canonical_sort_uniq(ref_pl.align_stage(
        [line for b in ref_buckets for line in b], rfr, REF_DEFAULT,
        RefAligner(use_tpu=False)))
    assert aligned == ref_aligned

    ours = reporter.stats_rows(aligned, fr, DEFAULT)
    assert ours == ref_reporter.stats_rows(aligned, rfr, REF_DEFAULT)
    assert len(ours) >= 8
    # the thread-pool fan-out keeps the rows and their order
    assert reporter.stats_rows(aligned, fr, DEFAULT, jobs=3) == ours
