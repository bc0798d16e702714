"""The port's query-range sharded stage-1 search
(``sedef_tpu_torch.models.seeder.ShardedPairSearch``, the pipeline's
sharded stage) against its whole-job search — the host route and the
route with the device prefilter forced on (CPU device) — and against
``sedef_tpu``'s seeds: the port's counterpart of
``tests/test_shard_search.py``.  Tolerance: byte-identical seeds and
equal funnel counters."""

import numpy as np
import pytest
import torch

from sedef_tpu.models import seeder as ref_seeder
from sedef_tpu.ops import dna as ref_dna
from sedef_tpu.ops.index import MinimizerIndex as RefIndex
from sedef_tpu_torch.config import DEFAULT
from sedef_tpu_torch.models import seeder
from sedef_tpu_torch.models.seeder import initial_search, sharded_pair_search
from sedef_tpu_torch.native import lib as native
from sedef_tpu_torch.ops import dna
from sedef_tpu_torch.ops import filter as filt
from sedef_tpu_torch.ops.index import MinimizerIndex

torch.set_num_threads(1)

if not native.has("search_range"):  # pragma: no cover
    pytest.skip("native library not built", allow_module_level=True)


def mutate(s, rate, rng):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate * 0.7:
            out.append("ACGT"[rng.integers(4)])
        elif r < rate * 0.85:
            continue
        elif r < rate:
            out.append(ch)
            out.append("ACGT"[rng.integers(4)])
        else:
            out.append(ch)
    return "".join(out)


def sparse_pair(rng, rc=False):
    fam = "".join(rng.choice(list("ACGT"), 1200))
    cp = dna.revcomp if rc else (lambda s: s)

    def lo(n):
        return "".join(rng.choice(list("acgt"), n))

    q = lo(4000) + mutate(fam, 0.05, rng) + lo(6000) \
        + mutate(fam, 0.10, rng) + lo(4000)
    r = lo(5000) + cp(mutate(fam, 0.08, rng)) + lo(7000)
    return q, r


def dense_pair(rng, rc=False):
    fam = "".join(rng.choice(list("ACGT"), 800))
    cp = dna.revcomp if rc else (lambda s: s)
    parts_q, parts_r = [], []
    for _ in range(12):
        parts_q.append("".join(rng.choice(list("acgt"), 250)))
        parts_q.append(mutate(fam, 0.06, rng))
        parts_r.append("".join(rng.choice(list("acgt"), 200)))
        parts_r.append(cp(mutate(fam, 0.10, rng)))
    return "".join(parts_q), "".join(parts_r)


def _beds(hits):
    return [h.to_bed() for h in hits]


def _ref_seeds(q, r, same, rc):
    qh = RefIndex(ref_dna.PackedSeq("q", q), 12, 16)
    rh = qh if same else RefIndex(ref_dna.PackedSeq("r", r, is_rc=rc),
                                  12, 16)
    return _beds(ref_seeder.initial_search(qh, rh, same,
                                           ref_seeder.DEFAULT,
                                           use_device=False))


@pytest.mark.parametrize("make,same,rc,n_shards,seed", [
    (sparse_pair, False, False, 4, 1),
    (sparse_pair, False, True, 4, 2),
    (dense_pair, False, False, 6, 3),
    (dense_pair, False, True, 3, 4),
    (dense_pair, True, False, 5, 77),
])
def test_sharded_matches_whole_job(make, same, rc, n_shards, seed,
                                   monkeypatch):
    rng = np.random.default_rng(seed)
    q, r = make(rng, rc=rc)
    qh = MinimizerIndex(dna.PackedSeq("q", q), 12, 16)
    rh = qh if same else MinimizerIndex(dna.PackedSeq("r", r, is_rc=rc),
                                        12, 16)
    filt.COUNTERS.reset()
    base = _beds(initial_search(qh, rh, same, DEFAULT, use_device=False))
    base_counts = {k: filt.COUNTERS[k] for k in filt.COUNTERS}
    filt.COUNTERS.reset()
    got = _beds(sharded_pair_search(qh, rh, same, DEFAULT,
                                    n_shards=n_shards))
    assert {k: filt.COUNTERS[k] for k in filt.COUNTERS} == base_counts
    monkeypatch.setattr(seeder, "PREFILTER_ON", True)
    monkeypatch.setattr(seeder, "PREFILTER_MIN_STEPS", 0)
    dev = _beds(initial_search(qh, rh, same, DEFAULT, use_device="cpu"))
    assert got == base == dev == _ref_seeds(q, r, same, rc)
    assert len(base) > 0


def test_chained_interface_is_exact():
    """Chaining shards with their true incoming state (no speculation)
    equals the whole-job run."""
    rng = np.random.default_rng(5)
    q, r = dense_pair(rng)
    qh = MinimizerIndex(dna.PackedSeq("q", q), 12, 16)
    rh = MinimizerIndex(dna.PackedSeq("r", r), 12, 16)
    rows = native.search(qh, rh, False, DEFAULT)
    bounds = seeder.shard_bounds(qh, 7)
    nxt, tree = 0, np.empty((0, 4), np.int32)
    chained = []
    for c in range(len(bounds) - 1):
        hits, nxt, tree, _ = native.search_range(
            qh, rh, False, DEFAULT, bounds[c], bounds[c + 1], nxt, tree)
        chained.extend(map(tuple, hits))
    assert chained == list(map(tuple, rows))
    assert len(chained) > 0


def test_sharded_with_executor():
    from concurrent.futures import ThreadPoolExecutor
    rng = np.random.default_rng(13)
    q, r = dense_pair(rng)
    qh = MinimizerIndex(dna.PackedSeq("q", q), 12, 16)
    rh = MinimizerIndex(dna.PackedSeq("r", r), 12, 16)
    base = _beds(initial_search(qh, rh, False, DEFAULT, use_device=False))
    times: list = []
    with ThreadPoolExecutor(max_workers=4) as ex:
        got = _beds(sharded_pair_search(qh, rh, False, DEFAULT, n_shards=8,
                                        submit=ex.submit, unit_times=times))
    assert got == base
    assert len(times) >= 2 and all(t >= 0 for t in times)


def test_search_stage_sharded_byte_identical(tmp_path, monkeypatch):
    """The sharded stage (pipeline._search_stage_sharded) streams the
    whole-job stage's seed lines in job order — the host route's, and the
    two-phase device route's with the prefilter forced on — with a unit
    report finer than the jobs."""
    from sedef_tpu_torch.io.fasta import FastaReference, generate_translation
    from sedef_tpu_torch.models import pipeline as pl
    from sedef_tpu_torch.models.genome_sim import simulate_genome, write_fasta

    chroms, _ = simulate_genome(600_000, 4, seed=9, n_chroms=3,
                                repeat_families=4, repeat_copies=8,
                                repeat_div=(0.05, 0.30))
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, chroms)
    fr = FastaReference(fa)
    bins = generate_translation(fr)
    base = pl.search_stage(fr, bins, DEFAULT, use_device=False)
    report: list = []
    sunk: list = []
    n = pl.search_stage(fr, bins, DEFAULT, use_device="cpu", jobs=2,
                        shard_bp=50_000, unit_report=report,
                        sink=lambda job: sunk.extend(job))
    assert sunk == base and n == len(base) > 0
    assert len(report) > len(bins) * (len(bins) + 1)  # finer than jobs
    ks = [u[0] for u in report]
    assert ks == sorted(ks)
    monkeypatch.setattr(seeder, "PREFILTER_ON", True)
    monkeypatch.setattr(seeder, "PREFILTER_MIN_STEPS", 0)
    assert pl.search_stage(fr, bins, DEFAULT, use_device="cpu", jobs=1,
                           shard_bp=0) == base
