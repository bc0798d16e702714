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


def _mosaic_pair(tmp_path, seed):
    """The same genome from ``seed`` with and without the mosaic cores, at a
    size a test holds (forward and reverse SDs, N-runs): (mosaic genome,
    plain genome, planted SDs, the mosaic genome's record)."""
    t = loader.traffic("genome-mosaic")
    t["recipe"] = dict(t["recipe"], length=1_200_000, n_sds=6,
                       sd_min=30_000, sd_max=40_000, n_run_every=199_000,
                       repeat_families=1, rc_fraction=0.5)
    plain = dict(t)
    del plain["mosaic"]
    g = sim_genome.make(t, seed, str(tmp_path / "m"), 0, 1)[0]
    p = sim_genome.make(plain, seed, str(tmp_path / "p"), 0, 1)[0]
    from reference.rows import read_fasta
    return read_fasta(g["fasta"]), read_fasta(p["fasta"]), p["planted"], g


def test_mosaic_recipe_is_byte_stable_for_a_seed(tmp_path):
    import hashlib
    a = _mosaic_pair(tmp_path / "a", 2**40 + 3)
    b = _mosaic_pair(tmp_path / "b", 2**40 + 3)
    c = _mosaic_pair(tmp_path / "c", 2**40 + 4)
    assert a[0] == b[0] and a[0] != c[0]
    h = hashlib.sha256(b"".join(a[0].values())).hexdigest()
    assert h == MOSAIC_DIGEST


# the digest of the mosaic genome above at seed 2**40 + 3 (chip_smoke.py's
# mosaic_genome core re-randomisation, the second copy's cores at the
# homologous places, generators/sim_genome)
MOSAIC_DIGEST = ("cbe533659fbb6e15fa0c74cbfcc115ef3c71acf504a7f50bacd4544050"
                 "b7b755")


def test_mosaic_changes_both_copies_of_forward_sds_only(tmp_path):
    """Cores re-randomised at the same offsets in both copies of each
    forward SD, nothing else; only the reverse SDs are reported as
    homologous end to end."""
    m, p, planted, g = _mosaic_pair(tmp_path, 2**40 + 3)
    assert {sd.is_rc for sd in planted} == {False, True}
    assert [sd for sd in g["planted"] if sd.is_rc] == \
        [sd for sd in planted if sd.is_rc]
    changed = {n: np.frombuffer(m[n], np.uint8)
               != np.frombuffer(p[n], np.uint8) for n in m}
    inside = {n: np.zeros(len(m[n]), bool) for n in m}
    for sd in planted:
        a = changed[sd.chrom_a][sd.a_start:sd.a_end]
        b = changed[sd.chrom_b][sd.b_start:sd.b_end]
        if sd.is_rc:
            assert not a.any() and not b.any()
            continue
        # long runs of changed bases at the same offsets in both copies (a
        # quarter of a core's bases unchanged by chance), conserved between
        n = min(len(a), len(b))
        assert a.mean() > 0.2 and b.mean() > 0.2
        assert (a[:n] & b[:n]).mean() > 0.1
        assert (a[:n] | b[:n]).mean() < 0.8
        inside[sd.chrom_a][sd.a_start:sd.a_end] = True
        inside[sd.chrom_b][sd.b_start:sd.b_end] = True
    for n in m:  # nothing outside the forward SDs' copies; cores upper
        assert not changed[n][~inside[n]].any()
        core = np.frombuffer(m[n], np.uint8)[changed[n]]
        assert set(core.tobytes()) <= set(b"ACGT")


def _kmers(seq: str, k: int = 11) -> set[str]:
    return {seq[i:i + k] for i in range(len(seq) - k + 1)}


def test_mosaic_lists_its_conserved_blocks_as_homologous_pairs(tmp_path):
    """Each forward SD's bases outside its cores, in both copies, are
    listed as conserved blocks at homologous places: unchanged by the
    mosaic, sharing the k-mers of their SD's divergence with each other
    and hardly any with the next block's place; together with the cores
    they make up the first copy."""
    m, p, planted, g = _mosaic_pair(tmp_path, 2**40 + 3)
    forward = [sd for sd in planted if not sd.is_rc]
    blocks = [b for b in g["planted"] if not b.is_rc]
    assert {b.divergence for b in blocks} == {sd.divergence for sd in forward}
    for sd in forward:
        mine = sorted((b for b in blocks if b.divergence == sd.divergence
                       and b.chrom_a == sd.chrom_a), key=lambda b: b.a_start)
        assert len(mine) >= 2
        assert mine[0].a_start == sd.a_start and mine[-1].a_end == sd.a_end
        changed = sum(x != y for x, y in zip(m[sd.chrom_a][sd.a_start:sd.a_end],
                                             p[sd.chrom_a][sd.a_start:sd.a_end]))
        cores = (sd.a_end - sd.a_start) - sum(b.a_end - b.a_start
                                              for b in mine)
        # a core's base is unchanged by chance a quarter of the time
        assert 0.6 * cores < changed <= cores
        for b, after in zip(mine, mine[1:] + [None]):
            a_seq = m[b.chrom_a][b.a_start:b.a_end]
            b_seq = m[b.chrom_b][b.b_start:b.b_end]
            assert a_seq == p[b.chrom_a][b.a_start:b.a_end]
            assert b_seq == p[b.chrom_b][b.b_start:b.b_end]
            shared = len(_kmers(a_seq) & _kmers(b_seq)) / len(_kmers(a_seq))
            assert shared > 0.5 * (1 - sd.divergence) ** 11
            if after is not None:  # the next block's place in the copy
                ln = b.b_end - b.b_start
                other = m[b.chrom_b][after.b_start:after.b_start + ln]
                assert len(_kmers(a_seq) & _kmers(other)) < 0.05 * shared * \
                    len(_kmers(a_seq))


def test_mosaic_keeps_the_n_runs(tmp_path):
    m, p, _, _ = _mosaic_pair(tmp_path, 2**40 + 3)
    for n in m:
        at = np.flatnonzero(np.frombuffer(m[n], np.uint8) == ord("N"))
        assert np.array_equal(
            at, np.flatnonzero(np.frombuffer(p[n], np.uint8) == ord("N")))
        assert len(at) >= 150


def test_sizes_seed_gives_every_seed_the_same_work(tmp_path):
    """With ``sizes_seed``, genome k of every seed plants SDs of the same
    sizes, divergences and orientations; the sequences differ."""
    t = loader.traffic("genome-mosaic")
    t["recipe"] = dict(t["recipe"], length=1_200_000, n_sds=4,
                       sd_min=30_000, sd_max=40_000, n_run_every=199_000,
                       repeat_families=1)

    del t["mosaic"]  # every planted SD listed

    def sizes(g):
        return sorted((sd.a_end - sd.a_start, sd.divergence, sd.is_rc)
                      for sd in g["planted"])
    a = sim_genome.make(t, 2**33 + 5, str(tmp_path / "a"), 0, 2)
    b = sim_genome.make(t, 2**31 + 6, str(tmp_path / "b"), 0, 2)
    assert [sizes(g) for g in a] == [sizes(g) for g in b]
    assert sizes(a[0]) != sizes(a[1])
    assert open(a[0]["fasta"]).read() != open(b[0]["fasta"]).read()
    specs = sim_genome.sd_specs(t["recipe"], t["sizes_seed"], 0, 0)
    assert sorted(specs) == sorted(sizes(a[0]))
