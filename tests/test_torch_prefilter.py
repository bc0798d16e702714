"""The port's stage-1 roll prefilter (``sedef_tpu_torch.ops.prefilter``)
against the reference package's (``sedef_tpu.ops.prefilter``, JAX on the
CPU): its three phase functions and ``RollPrefilter``'s verdicts on
repeat-rich plans, its soundness against the port's scalar
``SlidingJaccard`` roll, and ``initial_search`` / the two-phase
``search_stage`` with the prefilter forced on, byte-identical to the host
route and to ``sedef_tpu``'s seeds.  The port runs on the CPU device.
Tolerance: exact equality, values and dtypes (integer counts and
verdicts; seeds byte for byte)."""

import numpy as np
import pytest
import torch

from sedef_tpu.models import seeder as ref_seeder
from sedef_tpu.ops import dna as ref_dna
from sedef_tpu.ops import prefilter as ref_pf
from sedef_tpu.ops.index import MinimizerIndex as RefIndex
from sedef_tpu_torch.config import DEFAULT
from sedef_tpu_torch.models import seeder
from sedef_tpu_torch.native import lib as native
from sedef_tpu_torch.ops import dna
from sedef_tpu_torch.ops import filter as filt
from sedef_tpu_torch.ops import prefilter as pf
from sedef_tpu_torch.ops.index import MinimizerIndex
from sedef_tpu_torch.ops.stat_model import relaxed_jaccard_table

from test_torch_roll_engine import _family_pair, mutate, scalar_roll

torch.set_num_threads(1)

if not native.has("search_plan"):  # pragma: no cover
    pytest.skip("native library not built", allow_module_level=True)

CPU = torch.device("cpu")
K, L = DEFAULT.search.kmer_size, DEFAULT.search.min_read_size


def repeat_rich_pair(rng, rate, n_fams=6, copies=5):
    """Two sequences sharing diverged repeat families — most windows
    cluster candidates but fail the Jaccard gate after the scan."""
    fams = ["".join(rng.choice(list("ACGT"), 800)) for _ in range(n_fams)]
    q_parts, r_parts = [], []
    for f in fams:
        q_parts.append(mutate(f, rate * 0.4, rng))
        q_parts.append("".join(rng.choice(list("ACGT"), 200)))
    for f in fams:
        for _ in range(copies):
            r_parts.append(mutate(f, rate, rng))
            r_parts.append("".join(rng.choice(list("ACGT"), 150)))
    return "".join(q_parts), "".join(r_parts)


def _pair(q, r, same=False):
    qh = MinimizerIndex(dna.PackedSeq("q", q), K, 16)
    rh = qh if same else MinimizerIndex(dna.PackedSeq("r", r), K, 16)
    return qh, rh


def _ref_pair(q, r):
    return (RefIndex(ref_dna.PackedSeq("q", q), K, 16),
            RefIndex(ref_dna.PackedSeq("r", r), K, 16))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _ragged_arange(starts, counts):
    """concatenate([arange(s, s+c) for s, c in zip(starts, counts)])."""
    if int(counts.sum()) == 0:
        return np.empty(0, np.int64)
    return np.concatenate([np.arange(s, s + c, dtype=np.int64)
                           for s, c in zip(starts, counts)])


def _columns(qh, rh, plan):
    win, iv = plan
    woff = np.repeat(np.arange(len(win)), win[:, 3])
    return (win[woff, 1].astype(np.int32), win[woff, 2].astype(np.int32),
            iv[:, 0], iv[:, 2], iv[:, 4])


@pytest.mark.parametrize("seed,rate", [(0, 0.12), (1, 0.18), (2, 0.22)])
def test_phases_and_verdicts_match_reference(seed, rate):
    rng = np.random.default_rng(seed)
    q, r = repeat_rich_pair(rng, rate)
    qh, rh = _pair(q, r)
    plan = native.search_plan(qh, rh, False, DEFAULT)
    assert len(plan[1]), "no intervals planned - test setup broken"
    qws, qwe, t0, rws0, n_steps = _columns(qh, rh, plan)
    qk = qh.keys.astype(np.int32)
    rk = rh.keys.astype(np.int32)
    lut = relaxed_jaccard_table(320, K, DEFAULT).astype(np.int32)
    T = torch.from_numpy

    # per-interval query sketches
    got = pf._window_sketches_torch(T(qk), T(qws), T(qwe), T(lut), SQ=160)
    want = ref_pf._window_sketches(qk, qws, qwe, lut, SQ=160)
    for g, w in zip(got, want):
        _eq(g, w)
    qk_all, s_all = got[0], got[1]

    # phase A: span rows
    sa = rws0.astype(np.int32)
    sb = np.searchsorted(rh.locs, t0 + n_steps + L).astype(np.int32)
    _eq(pf._span_intersections_torch(T(rk), qk_all, T(sa), T(sb), SA=1024,
                                     n_shift=2 * K),
        ref_pf._span_intersections(rk, np.asarray(want[0]), sa, sb,
                                   SA=1024, n_shift=2 * K))

    # phase B: every interval's composition rows
    span_n = np.maximum(sb.astype(np.int64) - rws0, 0)
    ivs = np.arange(len(t0))
    idx = _ragged_arange(rws0, span_n)
    ev = rh.locs[idx].astype(np.int64)
    row_iv1 = np.repeat(ivs, span_n)
    lo, hi = t0[row_iv1], t0[row_iv1] + n_steps[row_iv1]
    rs = np.concatenate([np.clip(ev + 1, lo, hi),
                         np.clip(ev - L + 1, lo, hi), t0]).astype(np.int64)
    iv_id = np.concatenate([row_iv1, row_iv1, ivs]).astype(np.int32)
    a = np.searchsorted(rh.locs, rs).astype(np.int32)
    b = np.searchsorted(rh.locs, rs + L).astype(np.int32)
    _eq(pf._composition_ideals_torch(T(rk), qk_all, s_all, T(a), T(b),
                                     T(iv_id), RW=192, n_shift=2 * K),
        ref_pf._composition_ideals(rk, np.asarray(want[0]),
                                   np.asarray(want[1]), a, b, iv_id,
                                   RW=192, n_shift=2 * K))

    # the verdicts through the seeders' own dispatch
    got = seeder._device_prefilter_results(qh, rh, plan, DEFAULT, CPU)
    rqh, rrh = _ref_pair(q, r)
    want = ref_seeder._device_prefilter_results(rqh, rrh, plan,
                                                ref_seeder.DEFAULT)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[2].any()


@pytest.mark.parametrize("seed,rate", [(0, 0.12), (1, 0.18), (2, 0.22)])
def test_prefilter_sound_and_prunes(seed, rate, monkeypatch):
    """Every pruned interval's scalar roll ends below the gate; phase B
    runs in several row batches."""
    monkeypatch.setattr(pf, "ROW_BATCH", 256)
    monkeypatch.setattr(pf, "SPAN_BATCH", 64)
    rng = np.random.default_rng(seed)
    q, r = repeat_rich_pair(rng, rate)
    qh, rh = _pair(q, r)
    plan = native.search_plan(qh, rh, False, DEFAULT)
    win, iv = plan
    pf.reset_stats()
    bj, bs, ok = seeder._device_prefilter_results(qh, rh, plan, DEFAULT,
                                                  CPU)
    pruned = np.nonzero(ok & (bj < 0))[0]
    assert pf.STATS["intervals"] == len(iv)
    assert pf.STATS["pruned_a"] + pf.STATS["pruned_b"] == len(pruned)
    assert pf.STATS["rows"] > 256
    woff = np.repeat(np.arange(len(win)), win[:, 3])
    for i in pruned:
        ebj, _ = scalar_roll(qh, rh, int(win[woff[i], 1]),
                             int(win[woff[i], 2]), int(iv[i, 0]),
                             int(iv[i, 1]), L, DEFAULT)
        assert ebj < 0, i
    assert len(pruned) > 0
    if rate >= 0.18:
        assert len(pruned) >= len(iv) // 4


def test_prefilter_sound_masked_and_n():
    """Soft-masked + N-run inputs: HAS_N ref keys never count as matches,
    lowercase statuses are part of the key."""
    rng = np.random.default_rng(7)
    chars = list("ACGTacgt")
    base = "".join(rng.choice(chars, 1600))
    q = ("".join(rng.choice(chars, 300)) + base + "N" * 40
         + mutate(base, 0.2, rng))
    r = ("".join(rng.choice(chars, 400)) + mutate(base, 0.22, rng)
         + "N" * 25 + mutate(base, 0.12, rng))
    qh, rh = _pair(q, r)
    plan = native.search_plan(qh, rh, False, DEFAULT)
    win, iv = plan
    assert len(iv)
    got = seeder._device_prefilter_results(qh, rh, plan, DEFAULT, CPU)
    want = ref_seeder._device_prefilter_results(
        *_ref_pair(q, r), plan, ref_seeder.DEFAULT)
    for g, w in zip(got, want):
        _eq(g, w)
    bj, _, ok = got
    woff = np.repeat(np.arange(len(win)), win[:, 3])
    for i in np.nonzero(ok & (bj < 0))[0]:
        ebj, _ = scalar_roll(qh, rh, int(win[woff[i], 1]),
                             int(win[woff[i], 2]), int(iv[i, 0]),
                             int(iv[i, 1]), L, DEFAULT)
        assert ebj < 0, i


def _counters():
    return {k: filt.COUNTERS[k] for k in filt.COUNTERS}


@pytest.mark.parametrize("trial", range(4))
def test_prefilter_search_byte_identical(trial, monkeypatch):
    """initial_search with the prefilter forced on emits the host route's
    seeds, funnel counters and ``sedef_tpu``'s seeds, including same-genome
    runs where hit-tree pruning desyncs the plan."""
    rng = np.random.default_rng(300 + trial)
    q, r = _family_pair(rng, trial)
    same = trial % 2 == 0
    qh, rh = _pair(q, r)
    filt.COUNTERS.reset()
    host = [h.to_bed() for h in
            seeder.initial_search(qh, rh, same, DEFAULT, use_device=False)]
    host_counts = _counters()
    ref = [h.to_bed() for h in ref_seeder.initial_search(
        *_ref_pair(q, r), same, ref_seeder.DEFAULT, use_device=False)]
    monkeypatch.setattr(seeder, "PREFILTER_ON", True)
    monkeypatch.setattr(seeder, "PREFILTER_MIN_STEPS", 0)
    pf.reset_stats()
    filt.COUNTERS.reset()
    dev = [h.to_bed() for h in
           seeder.initial_search(qh, rh, same, DEFAULT, use_device="cpu")]
    assert pf.STATS["intervals"] > 0
    assert dev == host == ref
    assert _counters() == host_counts
    assert len(host) > 0
    # below the step floor the pair stays on the host
    monkeypatch.setattr(seeder, "PREFILTER_MIN_STEPS", 1 << 40)
    prep = seeder.prepare_device_search(qh, rh, same, DEFAULT, "cpu")
    assert prep.mode == "host" and prep.finish() == (None, None)
    # no device, or the gates off: no plan at all
    assert seeder.prepare_device_search(qh, rh, same, DEFAULT,
                                        False) is None
    monkeypatch.setattr(seeder, "PREFILTER_ON", False)
    assert seeder.prepare_device_search(qh, rh, same, DEFAULT,
                                        "cpu") is None


def test_prefilter_byte_identical_repeat_heavy(monkeypatch):
    rng = np.random.default_rng(42)
    q, r = repeat_rich_pair(rng, 0.22)
    qh, rh = _pair(q, r)
    base = [h.to_bed() for h in
            seeder.initial_search(qh, rh, False, DEFAULT, use_device=False)]
    monkeypatch.setattr(seeder, "PREFILTER_ON", True)
    monkeypatch.setattr(seeder, "PREFILTER_MIN_STEPS", 0)
    dev = [h.to_bed() for h in
           seeder.initial_search(qh, rh, False, DEFAULT, use_device="cpu")]
    assert base == dev


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    from sedef_tpu_torch.models.genome_sim import simulate_genome, write_fasta
    chroms, _ = simulate_genome(600_000, 4, seed=5, n_chroms=3,
                                repeat_families=4, repeat_copies=8,
                                repeat_div=(0.05, 0.30))
    fa = str(tmp_path_factory.mktemp("pf") / "g.fa")
    write_fasta(fa, chroms)
    return fa


@pytest.mark.parametrize("jobs", [1, 2])
def test_search_stage_two_phase_byte_identical(genome, jobs, monkeypatch):
    """search_job's two-phase loop (the prefilter queued for every
    chromosome pair, then collect + search) on the whole-job path emits the
    host route's seed lines and sedef_tpu's, over several chromosomes and
    both strands; jobs = 2 runs whole jobs on threads (shard_bp = 0)."""
    from sedef_tpu.io.fasta import FastaReference as RefFasta
    from sedef_tpu.io.fasta import generate_translation as ref_translation
    from sedef_tpu.models import pipeline as ref_pl
    from sedef_tpu_torch.io.fasta import FastaReference, generate_translation
    from sedef_tpu_torch.models import pipeline as pl

    fr = FastaReference(genome)
    bins = generate_translation(fr)
    host = pl.search_stage(fr, bins, DEFAULT, use_device=False)
    rfr = RefFasta(genome)
    ref = ref_pl.search_stage(rfr, ref_translation(rfr), ref_seeder.DEFAULT,
                              use_device=False)
    monkeypatch.setattr(seeder, "PREFILTER_ON", True)
    monkeypatch.setattr(seeder, "PREFILTER_MIN_STEPS", 0)
    pf.reset_stats()
    assignment = []
    dev = pl.search_stage(fr, bins, DEFAULT, use_device="cpu", jobs=jobs,
                          shard_bp=0, device_assignment=assignment)
    assert pf.STATS["intervals"] > 0 and pf.STATS["rows"] > 0
    assert dev == host == ref
    assert len(host) > 0
    assert assignment == [0] * len(assignment)  # one device: no rotation


def _phase_inputs(seed, rate):
    """Phase A's and phase B's arguments on one repeat-rich plan, as
    numpy arrays: (rk, qk_all, s_all, sa, sb, a, b, iv_id)."""
    rng = np.random.default_rng(seed)
    q, r = repeat_rich_pair(rng, rate)
    qh, rh = _pair(q, r)
    plan = native.search_plan(qh, rh, False, DEFAULT)
    assert len(plan[1]), "no intervals planned - test setup broken"
    qws, qwe, t0, rws0, n_steps = _columns(qh, rh, plan)
    rk = rh.keys.astype(np.int32)
    lut = relaxed_jaccard_table(320, K, DEFAULT).astype(np.int32)
    qk_all, s_all = (np.array(x) for x in ref_pf._window_sketches(
        qh.keys.astype(np.int32), qws, qwe, lut, SQ=160)[:2])
    sa = rws0.astype(np.int32)
    sb = np.searchsorted(rh.locs, t0 + n_steps + L).astype(np.int32)
    # composition rows: each interval's windows from t0 on, one a
    # minimizer, and windows wider than RW (a range of 300 minimizers)
    n = len(t0)
    iv_id = np.repeat(np.arange(n), 8).astype(np.int32)
    a = (np.repeat(sa, 8) + np.tile(np.arange(8), n)).astype(np.int32)
    b = np.searchsorted(rh.locs, rh.locs[np.minimum(a, len(rk) - 1)]
                        + L).astype(np.int32)
    b[::37] = a[::37] + 300
    b[5::41] = a[5::41]  # empty ranges
    return rk, qk_all, s_all, sa, sb, a, b, iv_id


@pytest.mark.parametrize("seed,rate", [(0, 0.12), (2, 0.22)])
def test_window_ideal_plain_versions_match_reference(seed, rate):
    """``_span_intersections_torch`` and ``_composition_ideals_torch``
    equal the reference's jitted ops, dtypes included, on rows with
    windows past RW and empty ones."""
    rk, qk_all, s_all, sa, sb, a, b, iv_id = _phase_inputs(seed, rate)
    T = torch.from_numpy
    span = pf._span_intersections_torch(T(rk), T(qk_all), T(sa), T(sb),
                                        SA=1024, n_shift=2 * K)
    _eq(span, ref_pf._span_intersections(rk, qk_all, sa, sb, SA=1024,
                                         n_shift=2 * K))
    comp = pf._composition_ideals_torch(T(rk), T(qk_all), T(s_all), T(a),
                                        T(b), T(iv_id), RW=192,
                                        n_shift=2 * K)
    _eq(comp, ref_pf._composition_ideals(rk, qk_all, s_all, a, b, iv_id,
                                         RW=192, n_shift=2 * K))
    assert (comp.numpy() == pf.INF32).any() and (comp.numpy() > 0).any()


def window_ideals_model(rk, qk_all, s_all, a, b, iv_id, width, s_const,
                        n_shift):
    """The window rows' ideals as ``rank_count`` of
    ``csrc/window_rows.cuh`` (which ``csrc/prefilter_intervals.cu`` runs)
    counts them, row by row in NumPy: the range's keys (HAS_N as INF)
    sorted, each distinct key's place in the query row by binary search, a
    shared key's union rank = the query keys below it + the ref-only
    distinct keys below it (an exclusive scan)."""
    out = np.empty(len(a), np.int32)
    for i in range(len(a)):
        if b[i] - a[i] > width:
            out[i] = pf.INF32
            continue
        j = np.clip(a[i] + np.arange(max(b[i] - a[i], 0)), 0, len(rk) - 1)
        keys = rk[j]
        keys = np.sort(np.where(keys >> n_shift == 2, pf.INF32, keys))
        new = (keys != pf.INF32) & np.r_[True, keys[1:] != keys[:-1]]
        k = keys[new]
        qrow = i if iv_id is None else iv_id[i]
        q = qk_all[qrow]
        s = s_const if s_all is None else s_all[qrow]
        lq = np.searchsorted(q, k, side="left")
        shared = q[np.minimum(lq, len(q) - 1)] == k
        before = np.cumsum(~shared) - (~shared)
        out[i] = int(((lq + before < s) & shared).sum())
    return out


@pytest.mark.parametrize("seed,rate", [(0, 0.12), (2, 0.22)])
def test_window_ideals_model_matches_plain(seed, rate):
    """The rank arithmetic of ``csrc/window_rows.cuh``'s ``rank_count``
    (the per-interval kernel's phase B) against the plain versions'
    tagged concat-sort, for both row functions."""
    rk, qk_all, s_all, sa, sb, a, b, iv_id = _phase_inputs(seed, rate)
    T = torch.from_numpy
    np.testing.assert_array_equal(
        window_ideals_model(rk, qk_all, None, sa, sb, None, 1024,
                            qk_all.shape[1] + 1024, 2 * K),
        pf._span_intersections_torch(T(rk), T(qk_all), T(sa), T(sb),
                                     SA=1024, n_shift=2 * K).numpy())
    np.testing.assert_array_equal(
        window_ideals_model(rk, qk_all, s_all, a, b, iv_id, 192, 0, 2 * K),
        pf._composition_ideals_torch(T(rk), T(qk_all), T(s_all), T(a),
                                     T(b), T(iv_id), RW=192,
                                     n_shift=2 * K).numpy())


def _sketch_inputs(seed):
    """Query keys with duplicate-heavy stretches, and query windows:
    plan-like rows, an empty window, qwe < qws, windows of more than SQ
    keys, a duplicate-heavy window, a window past the keys' end.  As numpy
    int32 arrays (q_keys, qws, qwe)."""
    rng = np.random.default_rng(seed)
    nq = 3000
    q_keys = rng.integers(0, 1 << 26, nq).astype(np.int32)
    q_keys[1000:1300] = rng.integers(0, 5, 300)
    q_keys[2000:2100] = 7
    qws = rng.integers(0, nq - 200, 40)
    qwe = qws + rng.integers(1, 120, 40)
    qws = np.r_[qws, 500, 600, 100, 900, 1000, 2000, nq - 50, 0]
    qwe = np.r_[qwe, 500, 590, 400, 1061, 1170, 2100, nq + 30, 160]
    return q_keys, qws.astype(np.int32), qwe.astype(np.int32)


@pytest.mark.parametrize("seed,lut_len", [(0, 321), (1, 40)])
def test_window_sketches_plain_version_matches_reference(seed, lut_len):
    """``_window_sketches_torch`` equals the reference's jitted op, values
    and dtypes, on the edge windows of ``_sketch_inputs`` (and a limit
    table shorter than SQ)."""
    q_keys, qws, qwe = _sketch_inputs(seed)
    lut = relaxed_jaccard_table(lut_len - 1, K, DEFAULT).astype(np.int32)
    T = torch.from_numpy
    got = pf._window_sketches_torch(T(q_keys), T(qws), T(qwe), T(lut),
                                    SQ=160)
    want = ref_pf._window_sketches(q_keys, qws, qwe, lut, SQ=160)
    for g, w in zip(got, want):
        _eq(g, w)
    s, ovf = got[1].numpy(), got[3].numpy()
    assert (s == 0).sum() >= 2 and ovf.sum() >= 2 and s.max() == 160


def bitonic_model(x):
    """``group_bitonic`` (csrc/row_sort.cuh) on a power-of-two row: the
    same compare-exchange network, index for index (the pairs of one step
    are disjoint, so a step is one vectorised exchange)."""
    x = x.copy()
    n = len(x)
    i = np.arange(n // 2)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            lo = ((i & ~(j - 1)) << 1) | (i & (j - 1))
            hi = lo + j
            u, v = x[lo], x[hi]
            swap = (u > v) == ((lo & k) == 0)
            x[lo], x[hi] = np.where(swap, v, u), np.where(swap, u, v)
            j >>= 1
        k <<= 1
    return x


def window_sketches_model(q_keys, qws, qwe, lut, SQ):
    """The query sketches as ``warp_sketch`` of ``csrc/window_rows.cuh``
    (which ``csrc/prefilter_intervals.cu`` runs) builds them, row by row:
    the gathered keys (the first SQ of the window, an index past the keys
    clamped) sorted by the bitonic network over the next power of two
    above their count, then the warp's compaction, 32 lanes a step: a key
    is kept where it is not INF and differs from its left neighbour, and
    lands at the kept keys of the earlier steps plus the kept lanes below
    it (ballot and popc)."""
    B = len(qws)
    qk = np.full((B, SQ), pf.INF32, np.int32)
    s_out = np.zeros(B, np.int32)
    for r in range(B):
        n = int(np.clip(int(qwe[r]) - int(qws[r]), 0, SQ))
        n2 = 2
        while n2 < n:
            n2 <<= 1
        x = np.full(n2, pf.INF32, np.int32)
        x[:n] = q_keys[np.clip(qws[r] + np.arange(n), 0, len(q_keys) - 1)]
        x = bitonic_model(x)
        s = 0
        for base in range(0, n2, 32):
            j = base + np.arange(32)
            v = np.where(j < n2, x[np.minimum(j, n2 - 1)], pf.INF32)
            left = x[np.clip(j - 1, 0, n2 - 1)]
            keep = (v != pf.INF32) & ((j == 0) | (left != v))
            below = np.cumsum(keep) - keep  # popc(ballot & lanes below)
            qk[r, s + below[keep]] = v[keep]
            s += int(keep.sum())
        s_out[r] = s
    limit = lut[np.minimum(s_out, len(lut) - 1)]
    return qk, s_out, limit, (qwe - qws) > SQ


@pytest.mark.parametrize("seed", [0, 1])
def test_window_sketches_model_matches_plain(seed):
    """``warp_sketch``'s sort network and ballot compaction against the
    plain version's two row sorts, on the edge windows, at SQ 160 and
    48."""
    q_keys, qws, qwe = _sketch_inputs(seed)
    lut = relaxed_jaccard_table(320, K, DEFAULT).astype(np.int32)
    T = torch.from_numpy
    for SQ in (160, 48):
        want = pf._window_sketches_torch(T(q_keys), T(qws), T(qwe),
                                         T(lut), SQ=SQ)
        for g, w in zip(window_sketches_model(q_keys, qws, qwe, lut, SQ),
                        want):
            np.testing.assert_array_equal(g, w.numpy())


# ---------------------------------------------------------------------------
# The per-interval flow: ``_interval_verdicts`` (csrc/prefilter_intervals.cu
# on a card) and its plain version against the reference's RollPrefilter
# ---------------------------------------------------------------------------

def _ref_records(q_keys, r_keys, r_locs, lut, cols, L_, SQ=160, RW=192,
                 SA=1024):
    """The reference package's RollPrefilter on the plan columns, as the
    port's (n, 2) int32 records: 1 where its phase A prunes an interval, 2
    where its phase B does, else 0; and the interval's composition rows
    (its phase-B row ids counted)."""
    import jax.numpy as jnp
    rp = ref_pf.RollPrefilter(K, lut, L_, SQ=SQ, RW=RW, SA=SA)
    qws, qwe, t0, rws0, n_steps = cols
    n = len(qws)
    pend = rp.dispatch(jnp.asarray(q_keys), jnp.asarray(r_keys), r_locs,
                       qws, qwe, t0, rws0, n_steps)
    ctx = pend._ctx
    span_i, limit, s_all, qovf = (np.asarray(ctx[k])[:n] for k in (
        "span_i", "limit", "s_all", "qovf"))
    pruned_a = ~qovf & (s_all > 0) & (span_i < limit)
    rows = np.zeros(n, np.int32)
    real = rp._dispatch_compositions

    def spy(c, survivors):
        pending, row_iv = real(c, survivors)
        rows[:] = np.bincount(row_iv, minlength=n)
        return pending, row_iv

    rp._dispatch_compositions = spy
    _, _, ok = pend.collect()
    code = np.where(pruned_a, 1, np.where(ok, 2, 0)).astype(np.int32)
    return np.stack([code, rows], axis=1)


def _plan_tensor(cols):
    return torch.from_numpy(np.stack([np.asarray(c, np.int64)
                                      for c in cols]).astype(np.int32))


@pytest.mark.parametrize("seed,rate", [(0, 0.12), (1, 0.18), (2, 0.22)])
def test_interval_verdicts_and_stats_match_reference(seed, rate):
    """RollPrefilter's verdicts and STATS (intervals, pruned in A and in B,
    composition rows) on the CPU equal the reference's on the same plan;
    ``_interval_verdicts`` on CPU tensors is its plain version record for
    record and launches nothing."""
    rng = np.random.default_rng(seed)
    q, r = repeat_rich_pair(rng, rate)
    qh, rh = _pair(q, r)
    plan = native.search_plan(qh, rh, False, DEFAULT)
    cols = _columns(qh, rh, plan)
    lut = relaxed_jaccard_table(320, K, DEFAULT).astype(np.int32)
    rqh, rrh = _ref_pair(q, r)
    want = _ref_records(rqh.keys.astype(np.int32),
                        rrh.keys.astype(np.int32), rrh.locs, lut, cols, L)
    T = torch.from_numpy
    args = (T(qh.keys.astype(np.int32)), T(rh.keys.astype(np.int32)),
            T(rh.locs.astype(np.int32)), T(lut), _plan_tensor(cols))
    kw = dict(L=L, SQ=160, RW=192, SA=1024, n_shift=2 * K)
    before = [w.launches for w in pf.KERNEL_WRAPPERS]
    got = pf._interval_verdicts(*args, **kw)
    assert torch.equal(got, pf._interval_verdicts_torch(*args, **kw))
    assert [w.launches for w in pf.KERNEL_WRAPPERS] == before
    _eq(got, want)
    assert (want[:, 0] > 0).any() and (want[:, 1] > 0).any()

    pf.reset_stats()
    bj, bs, ok = seeder._device_prefilter_results(qh, rh, plan, DEFAULT,
                                                  CPU)
    _eq(ok, want[:, 0] > 0)
    _eq(bj, np.where(want[:, 0] > 0, -1, 0).astype(np.int32))
    assert pf.STATS["intervals"] == len(want)
    assert pf.STATS["pruned_a"] == int((want[:, 0] == 1).sum())
    assert pf.STATS["pruned_b"] == int((want[:, 0] == 2).sum())
    assert pf.STATS["rows"] == int(want[:, 1].sum())


L_E = 40  # the edge worlds' init_len
N_SHIFT = 2 * K


def _edge_world(case, seed=11):
    """Ref loci and keys, query keys, a limit table and plan columns built
    so that ``case`` happens, with the SQ, RW and SA it needs; returns
    (q_keys, r_keys, r_locs, lut, cols, dict(SQ=, RW=, SA=))."""
    rng = np.random.default_rng(seed)
    n_r = 700
    gaps = rng.integers(1, 10, n_r)
    gaps[300] = 400  # a gap wider than a window: spans of no loci
    r_locs = np.cumsum(gaps).astype(np.int32)
    alphabet = rng.choice(1 << 20, 48, replace=False).astype(np.int32)
    r_keys = rng.choice(alphabet, n_r).astype(np.int32)
    q_keys = rng.choice(alphabet, 600).astype(np.int32)
    lut = np.minimum(np.arange(321) // 5 + 1, 12).astype(np.int32)
    size = dict(SQ=160, RW=192, SA=1024)
    n = 48
    t0 = rng.integers(0, int(r_locs[-1]) - 200, n)
    n_steps = rng.integers(0, 120, n)
    qws = rng.integers(0, 500, n)
    qwe = qws + rng.integers(5, 60, n)
    if case == "span_n_0":      # the t0 window alone
        t0[:] = r_locs[299] + 1 + rng.integers(0, 300, n)
        n_steps[:] = rng.integers(0, 400 - L_E - 320, n).clip(0)
        t0[::4] = rng.integers(0, int(r_locs[-1]) - 200, n)[::4]
        lut[::2] = 0  # limit 0 at even s: phase A cannot prune, B runs
    elif case == "n_steps_0":
        n_steps[:] = 0
    elif case == "span_over_SA_windows_fit":
        size.update(SA=12, RW=64)
        n_steps[:] = rng.integers(80, 300, n)
    elif case == "prune_A_window_over_RW":
        size.update(RW=3)
        # query keys the ref lacks but for a few: phase A prunes
        q_keys = np.where(rng.random(600) < 0.03, q_keys,
                          rng.integers(1 << 21, 1 << 22, 600)).astype(
                              np.int32)
    elif case == "query_over_SQ":
        size.update(SQ=24)
        qwe[::2] = qws[::2] + rng.integers(25, 60, n)[::2]
    elif case == "s_zero":
        qwe[::2] = qws[::2]
        qwe[1::4] = qws[1::4] - 3
    elif case == "has_n_keys":
        has_n = (2 << N_SHIFT) | (r_keys & 0xffff)
        r_keys[::3] = has_n[::3]
        q_keys[::4] = has_n[:600:4]  # the query side keeps them
    elif case == "window_past_halo":  # bounds outside the kernel's stage
        size.update(RW=6)
        n_steps[:] = rng.integers(200, 500, n)
    elif case == "duplicate_ref_keys":
        r_keys[100:400:2] = alphabet[3]
        r_keys[101:400:4] = alphabet[5]
        t0[::2] = rng.integers(r_locs[100], r_locs[350], n)[::2]
    rws0 = np.searchsorted(r_locs, t0, side="left")
    cols = (qws.astype(np.int32), qwe.astype(np.int32), t0, rws0, n_steps)
    return q_keys, r_keys, r_locs, lut, cols, size


def _edge_facts(r_locs, cols, size):
    """Per interval: span_n, whether the query window overflows SQ, and
    the widest composition window in loci."""
    qws, qwe, t0, rws0, n_steps = (np.asarray(c, np.int64) for c in cols)
    span_end = np.searchsorted(r_locs, t0 + n_steps + L_E)
    span_n = np.maximum(span_end - rws0, 0)
    widest = np.zeros(len(t0), np.int64)
    for i in range(len(t0)):
        locs = r_locs[rws0[i]:span_end[i]].astype(np.int64)
        rs = np.r_[np.clip(locs + 1, t0[i], t0[i] + n_steps[i]),
                   np.clip(locs - L_E + 1, t0[i], t0[i] + n_steps[i]),
                   t0[i]]
        widest[i] = (np.searchsorted(r_locs, rs + L_E)
                     - np.searchsorted(r_locs, rs)).max()
    return span_n, (qwe - qws) > size["SQ"], widest


EDGE_CASES = ("span_n_0", "n_steps_0", "span_over_SA_windows_fit",
              "prune_A_window_over_RW", "query_over_SQ", "s_zero",
              "has_n_keys", "duplicate_ref_keys", "window_past_halo")


@pytest.mark.parametrize("case", EDGE_CASES)
def test_interval_verdicts_edge_cases_match_reference(case):
    """Each edge case of the per-interval flow, checked to occur: the
    plain version's records equal the reference RollPrefilter's."""
    q_keys, r_keys, r_locs, lut, cols, size = _edge_world(case)
    span_n, qovf, widest = _edge_facts(r_locs, cols, size)
    want = _ref_records(q_keys, r_keys, r_locs, lut, cols, L_E, **size)
    T = torch.from_numpy
    got = pf._interval_verdicts_torch(
        T(q_keys), T(r_keys), T(r_locs), T(lut), _plan_tensor(cols),
        L=L_E, n_shift=N_SHIFT, **size)
    _eq(got, want)
    code = want[:, 0]
    if case == "span_n_0":
        assert ((span_n == 0) & (want[:, 1] == 1)).sum() >= 4
        assert ((span_n == 0) & (code == 1)).sum() >= 4
    elif case == "n_steps_0":
        assert (want[:, 1] > 0).any()
    elif case == "span_over_SA_windows_fit":
        big = (span_n > size["SA"]) & (widest <= size["RW"]) & ~qovf
        assert big.sum() >= 10 and (code[big] != 1).all()
        assert (code[big] == 2).any() and (code[big] == 0).any()
    elif case == "prune_A_window_over_RW":
        assert ((code == 1) & (widest > size["RW"])).sum() >= 10
    elif case == "query_over_SQ":
        assert qovf.sum() >= 10
        assert (code[qovf] == 0).all() and (want[qovf, 1] == 0).all()
    elif case == "s_zero":
        empty = np.asarray(cols[1]) <= np.asarray(cols[0])
        assert empty.sum() >= 10 and (want[empty] == 0).all()
    elif case == "window_past_halo":
        assert (widest > size["RW"] + 1).sum() >= 10
    else:
        assert (code == 2).any() or (code == 1).any()


def warp_lower_bound_model(locs, lo, hi, x):
    """``warp_lower_bound`` (csrc/window_rows.cuh): 32 evenly spaced probes
    a round, the gap of the last probe below x kept."""
    rounds = 0
    while lo < hi:
        step = (hi - lo + 31) // 32
        p = lo + np.arange(32) * step
        c = int(((p < hi) & (locs[np.minimum(p, hi - 1)] < x)).sum())
        nhi = min(lo + c * step, hi)
        lo, hi = (lo + (c - 1) * step + 1, nhi) if c else (lo, lo)
        rounds += 1
    return lo


def interval_kernel_model(q_keys, r_keys, r_locs, lut, cols, L_, SQ, RW,
                          SA, n_shift, tile):
    """``csrc/prefilter_intervals.cu`` interval by interval in NumPy: the
    warp's sketch, span_end by the 32-way search, the tile of ``tile`` loci
    staged with RW + 1 loci of halo and its bracket, phase A's hit flags
    over the sketch slots, phase B's rows tile by tile (the removes, the
    adds, then the t0 window in the first tile), each window's bounds
    searched in the stage when the bracket holds them and over all the
    loci when not, its keys from the stage or the ref's, sorted by the
    bitonic network and counted by the rank arithmetic, and the stop at the
    first window whose ideal reaches the limit.  Returns the (n, 2)
    records and how many bounds were searched in a stage and outside."""
    locs = r_locs.astype(np.int64)
    n_rk = len(locs)
    qws, qwe, t0s, rws0s, steps = (np.asarray(c, np.int64) for c in cols)
    n = len(qws)
    out = np.zeros((n, 2), np.int32)
    halo = RW + 1
    searched = dict(staged=0, global_=0, tiles=0, phase_b=0)

    def key(i):
        k = int(r_keys[i])
        return pf.INF32 if k >> n_shift == 2 else k

    for iv in range(n):
        if qwe[iv] - qws[iv] > SQ:
            continue
        qk, s, limit, _ = window_sketches_model(
            q_keys, qws[iv:iv + 1], qwe[iv:iv + 1], lut, SQ)
        q, s, limit = qk[0], int(s[0]), int(limit[0])
        if s == 0:
            continue
        t0, rws0 = int(t0s[iv]), int(rws0s[iv])
        t1 = t0 + int(steps[iv])
        span_end = warp_lower_bound_model(locs, 0, n_rk, t1 + L_)
        span_n = max(span_end - rws0, 0)

        def stage(lo, hi):
            s0 = min(max(max(lo - halo, rws0), 0), n_rk)
            s1 = min(max(min(hi + halo, span_end), s0), n_rk)
            left = -(1 << 62) if s0 == 0 else locs[s0 - 1]
            right = 1 << 62 if s1 == n_rk else locs[s1]
            return s0, s1, left, right

        s0, s1, left, right = stage(rws0, rws0 + min(span_n, tile))
        span_i = pf.INF32
        if span_n <= SA:
            flags = np.zeros(SQ, bool)
            for j in range(span_n):
                k = key(rws0 + j)
                if k == pf.INF32:
                    continue
                pos = int(np.searchsorted(q, k))
                if pos < SQ and q[pos] == k:
                    flags[pos] = True
            span_i = int(flags.sum())
        if span_i < limit:
            out[iv] = (1, 0)
            continue

        searched["phase_b"] += 1
        alive = False
        lo, first = rws0, True
        while first or lo < rws0 + span_n:
            hi = min(lo + tile, rws0 + span_n)
            if not first:
                s0, s1, left, right = stage(lo, hi)
            searched["tiles"] += 1
            cnt = hi - lo

            def find(x):
                if left < x <= right:
                    searched["staged"] += 1
                    return s0 + warp_lower_bound_model(locs[s0:s1], 0,
                                                       s1 - s0, x)
                searched["global_"] += 1
                return warp_lower_bound_model(locs, 0, n_rk, x)

            for r in range(2 * cnt + first):
                rs = t0
                if r < 2 * cnt:
                    loc = int(locs[lo + (r if r < cnt else r - cnt)])
                    rs = min(max(loc + 1 if r < cnt else loc - L_ + 1, t0),
                             t1)
                a, b = find(rs), find(rs + L_)
                ideal = pf.INF32
                if b - a <= RW:
                    m = max(b - a, 0)
                    n2 = 2
                    while n2 < m:
                        n2 <<= 1
                    row = np.full(n2, pf.INF32, np.int64)
                    row[:m] = [key(a + j) for j in range(m)]
                    row = bitonic_model(row)
                    new = (row != pf.INF32) & np.r_[True, row[1:] != row[:-1]]
                    k = row[new]
                    lq = np.searchsorted(q, k, side="left")
                    shared = q[np.minimum(lq, SQ - 1)] == k
                    before = np.cumsum(~shared) - (~shared)
                    ideal = int(((lq + before < s) & shared).sum())
                if ideal >= limit:
                    alive = True
                    break
            if alive:
                break
            lo, first = lo + tile, False
        out[iv] = (0 if alive else 2, 2 * span_n + 1)
    return out, searched


@pytest.mark.parametrize("tile", [1024, 16, 3])
@pytest.mark.parametrize("world", ["plan", "edges"])
def test_interval_kernel_model_matches_plain(world, tile):
    """The kernel's per-interval algorithm (device-side event enumeration,
    staged binary search with its bracket and the search over all loci
    outside it, in-block maximum with its early stop) against the plain
    version, on a repeat-rich plan and on every edge world, with the
    kernel's tile and with tiles narrow enough that spans take several and
    bounds fall outside the stage."""
    T = torch.from_numpy
    if world == "plan":
        rng = np.random.default_rng(1)
        q, r = repeat_rich_pair(rng, 0.18)
        qh, rh = _pair(q, r)
        plan = native.search_plan(qh, rh, False, DEFAULT)
        cols = _columns(qh, rh, plan)
        worlds = [(qh.keys.astype(np.int32), rh.keys.astype(np.int32),
                   rh.locs.astype(np.int32),
                   relaxed_jaccard_table(320, K, DEFAULT).astype(np.int32),
                   cols, dict(SQ=160, RW=192, SA=1024), L)]
    else:
        worlds = [_edge_world(c)[:6] + (L_E,) for c in EDGE_CASES]
    totals = dict(staged=0, global_=0, tiles=0, phase_b=0)
    for q_keys, r_keys, r_locs, lut, cols, size, L_ in worlds:
        want = pf._interval_verdicts_torch(
            T(q_keys), T(r_keys), T(r_locs), T(lut), _plan_tensor(cols),
            L=L_, n_shift=N_SHIFT, **size).numpy()
        got, searched = interval_kernel_model(
            q_keys, r_keys, r_locs, lut, cols, L_, n_shift=N_SHIFT,
            tile=tile, **size)
        np.testing.assert_array_equal(got, want)
        for k in searched:
            totals[k] += searched[k]
    assert totals["staged"] > 0
    if tile < 1024:  # spans over several tiles
        assert totals["tiles"] > totals["phase_b"] > 0
    if world == "edges" and tile == 3:  # windows wider than tile + halo
        assert totals["global_"] > 0


@pytest.mark.parametrize("case", ["meta", "mixed", "rws0_past_loci"])
def test_interval_wrapper_refuses_other_devices(case):
    """Keys on a device that is no CPU and no card, keys and plan on two
    devices, and a plan whose rws0 is past the loci: ``ValueError``."""
    m = torch.zeros(4, dtype=torch.int32, device="meta")
    c = torch.zeros(4, dtype=torch.int32)
    plan = torch.zeros((5, 4), dtype=torch.int32, device="meta")
    kw = dict(L=L, SQ=160, RW=192, SA=1024, n_shift=2 * K)
    with pytest.raises(ValueError):
        if case == "meta":
            pf._interval_verdicts(m, m, m, m, plan, **kw)
        elif case == "mixed":
            pf._interval_verdicts(c, c, c, c, plan, **kw)
        else:
            prefilter = pf.RollPrefilter(K, np.ones(8, np.int32), L,
                                         device="cpu")
            prefilter.dispatch(c, c, c, [0], [4], [0], [9], [0])
