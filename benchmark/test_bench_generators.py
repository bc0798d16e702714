"""The traffic generators: the same seed gives the same inputs, other seeds
other inputs of the same regime."""

import numpy as np
import pytest

from generators import sd_pairs, sim_genome
from harness import loader


def _recipe(**kw):
    r = dict(loader.traffic("genome-dense")["recipe"])
    r.update(kw)
    return r


def test_genome_deterministic_from_seed(tmp_path):
    t = dict(loader.traffic("genome-dense"),
             recipe=_recipe(length=600_000, n_sds=5, repeat_families=2))
    a = sim_genome.make(t, 2**40 + 9, str(tmp_path / "a"), 0, 2)
    b = sim_genome.make(t, 2**40 + 9, str(tmp_path / "b"), 0, 2)
    c = sim_genome.make(t, 2**40 + 10, str(tmp_path / "c"), 0, 1)
    fa = [open(g["fasta"]).read() for g in a]
    assert fa == [open(g["fasta"]).read() for g in b]
    assert fa[0] != fa[1]  # no genome repeats in a pool
    assert fa[0] != open(c[0]["fasta"]).read()
    assert all(g["bases"] == 600_000 for g in a)


def test_copy_keeps_the_original_draws():
    """The copy draws exactly as the original generator: the same calls in
    the same order (pinned by a digest of one genome)."""
    import hashlib
    chroms, planted = sim_genome.simulate_genome(
        length=300_000, n_sds=4, sd_min=1300, sd_max=20_000, n_chroms=2,
        seed=5, n_run_every=99_700, repeat_families=2, repeat_copies=10,
        repeat_len=(500, 2500))
    h = hashlib.sha256("".join(chroms.values()).encode()).hexdigest()
    assert len(planted) == 4
    assert h == ORIGINAL_DIGEST


# the digest of sedef_tpu_torch/models/genome_sim.simulate_genome's genome
# with these arguments at commit a1f3aa7
ORIGINAL_DIGEST = ("16b37c4eb695ecad61c128208531da661bca0d3c282439333a72"
                   "21d96b4eaafd")


def test_recipe_keeps_its_ranges_and_plants_what_it_reports(tmp_path):
    t = dict(loader.traffic("genome-dense"),
             recipe=_recipe(length=2_000_000, n_sds=16, repeat_families=6))
    g = sim_genome.make(t, 7, str(tmp_path), 0, 1)[0]
    planted = g["planted"]
    assert all(1300 <= p.a_end - p.a_start < 20_000 for p in planted)
    assert all(0 <= p.divergence <= 0.12 for p in planted)
    from reference.rows import read_fasta
    chroms = read_fasta(g["fasta"])
    for p in planted:  # both copies uppercase
        assert chroms[p.chrom_a][p.a_start:p.a_end].isupper()
        assert chroms[p.chrom_b][p.b_start:p.b_end].isupper()
    fai = open(g["fasta"] + ".fai").read().split()
    assert fai[:2] == ["chrS1", "1000000"]


def test_dense_recipe_seed_density(tmp_path):
    """The dense recipe sits near hg19's seed density (0.75 seeds/Kbp) on
    the program's host route at the cell's 4 Mbp."""
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.models import pipeline
    from sedef_tpu_torch.ops.wavefront import WavefrontAligner
    g = sim_genome.make(loader.traffic("genome-dense"), 31, str(tmp_path),
                        0, 1)[0]
    out = str(tmp_path / "out")
    pipeline.run_pipeline(g["fasta"], out, DEFAULT, jobs=2, quiet=True,
                          aligner=WavefrontAligner(DEFAULT, device="cpu"))
    seeds = open(out + "/seeds.bed").read().splitlines()
    per_kbp = len(seeds) / (g["bases"] / 1000)
    assert 0.45 <= per_kbp <= 1.0, per_kbp


def test_pairs_deterministic_and_in_regime():
    t = dict(loader.traffic("pairs-rand"))
    a = sd_pairs.make(t, 2**33 + 1, 0, 62)
    b = sd_pairs.make(t, 2**33 + 1, 0, 62)
    c = sd_pairs.make(t, 2**33 + 2, 0, 62)
    assert a == b and a != c
    errs = sorted(p["error"] for p in a)
    assert errs == sorted(list(range(31)) * 2)  # each rate twice
    assert sorted(p["error"] for p in c) == errs  # the same work, reordered
    lens = [len(p["seq1"]) for p in a]
    assert min(lens) >= 1000 and max(lens) <= 100_000
    assert min(lens) < 1000 + 99_000 / 31 and max(lens) > 100_000 - 99_000 / 31
    assert all(set(p["seq1"]) <= set("ACGT") for p in a)


@pytest.mark.parametrize("error", [0, 6, 15])
def test_make_small_rates(error):
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 4, 200_000).astype(np.uint8)
    out = sd_pairs.make_small(rng, seq, error)
    # deletions and insertions at error//3 % each: the length holds
    assert abs(len(out) - len(seq)) < 0.01 * len(seq) + 50
    if error == 0:
        assert np.array_equal(out, seq)


def test_make_large_budget():
    rng = np.random.default_rng(4)
    seq = rng.integers(0, 4, 50_000).astype(np.uint8)
    out = sd_pairs.make_large(rng, seq, 15)
    assert abs(len(out) - len(seq)) <= 15 * len(seq) // 100
