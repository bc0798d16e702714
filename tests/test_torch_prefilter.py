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
    got = pf._window_sketches(T(qk), T(qws), T(qwe), T(lut), SQ=160)
    want = ref_pf._window_sketches(qk, qws, qwe, lut, SQ=160)
    for g, w in zip(got, want):
        _eq(g, w)
    qk_all, s_all = got[0], got[1]

    # phase A: span rows
    sa = rws0.astype(np.int32)
    sb = np.searchsorted(rh.locs, t0 + n_steps + L).astype(np.int32)
    _eq(pf._span_intersections(T(rk), qk_all, T(sa), T(sb), SA=1024,
                               n_shift=2 * K),
        ref_pf._span_intersections(rk, np.asarray(want[0]), sa, sb,
                                   SA=1024, n_shift=2 * K))

    # phase B: every interval's composition rows
    span_n = np.maximum(sb.astype(np.int64) - rws0, 0)
    ivs = np.arange(len(t0))
    idx = pf._ragged_arange(rws0, span_n)
    ev = rh.locs[idx].astype(np.int64)
    row_iv1 = np.repeat(ivs, span_n)
    lo, hi = t0[row_iv1], t0[row_iv1] + n_steps[row_iv1]
    rs = np.concatenate([np.clip(ev + 1, lo, hi),
                         np.clip(ev - L + 1, lo, hi), t0]).astype(np.int64)
    iv_id = np.concatenate([row_iv1, row_iv1, ivs]).astype(np.int32)
    a = np.searchsorted(rh.locs, rs).astype(np.int32)
    b = np.searchsorted(rh.locs, rs + L).astype(np.int32)
    _eq(pf._composition_ideals(T(rk), qk_all, s_all, T(a), T(b), T(iv_id),
                               RW=192, n_shift=2 * K),
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
def test_window_ideal_wrappers_on_cpu_are_plain_and_reference(seed, rate):
    """On CPU tensors ``_span_intersections`` and ``_composition_ideals``
    are their plain versions and equal the reference's jitted ops, dtypes
    included; no kernel is launched."""
    rk, qk_all, s_all, sa, sb, a, b, iv_id = _phase_inputs(seed, rate)
    T = torch.from_numpy
    before = [w.launches for w in pf.KERNEL_WRAPPERS]
    span = pf._span_intersections(T(rk), T(qk_all), T(sa), T(sb), SA=1024,
                                  n_shift=2 * K)
    assert torch.equal(span, pf._span_intersections_torch(
        T(rk), T(qk_all), T(sa), T(sb), SA=1024, n_shift=2 * K))
    _eq(span, ref_pf._span_intersections(rk, qk_all, sa, sb, SA=1024,
                                         n_shift=2 * K))
    comp = pf._composition_ideals(T(rk), T(qk_all), T(s_all), T(a), T(b),
                                  T(iv_id), RW=192, n_shift=2 * K)
    assert torch.equal(comp, pf._composition_ideals_torch(
        T(rk), T(qk_all), T(s_all), T(a), T(b), T(iv_id), RW=192,
        n_shift=2 * K))
    _eq(comp, ref_pf._composition_ideals(rk, qk_all, s_all, a, b, iv_id,
                                         RW=192, n_shift=2 * K))
    assert (comp.numpy() == pf.INF32).any() and (comp.numpy() > 0).any()
    assert [w.launches for w in pf.KERNEL_WRAPPERS] == before


def window_ideals_model(rk, qk_all, s_all, a, b, iv_id, width, s_const,
                        n_shift):
    """``csrc/window_ideals.cu`` row by row in NumPy: the range's keys
    (HAS_N as INF) sorted, each distinct key's place in the query row by
    binary search, a shared key's union rank = the query keys below it +
    the ref-only distinct keys below it (an exclusive scan)."""
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
    """The kernel's rank arithmetic against the plain versions' tagged
    concat-sort, for both ops."""
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
def test_window_sketches_wrapper_on_cpu_is_plain_and_reference(seed,
                                                               lut_len):
    """On CPU tensors ``_window_sketches`` is its plain version and equals
    the reference's jitted op, values and dtypes, on the edge windows of
    ``_sketch_inputs`` (and a limit table shorter than SQ); no kernel is
    launched."""
    q_keys, qws, qwe = _sketch_inputs(seed)
    lut = relaxed_jaccard_table(lut_len - 1, K, DEFAULT).astype(np.int32)
    T = torch.from_numpy
    before = [w.launches for w in pf.KERNEL_WRAPPERS]
    got = pf._window_sketches(T(q_keys), T(qws), T(qwe), T(lut), SQ=160)
    plain = pf._window_sketches_torch(T(q_keys), T(qws), T(qwe), T(lut),
                                      SQ=160)
    want = ref_pf._window_sketches(q_keys, qws, qwe, lut, SQ=160)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        _eq(g, w)
    s, ovf = got[1].numpy(), got[3].numpy()
    assert (s == 0).sum() >= 2 and ovf.sum() >= 2 and s.max() == 160
    assert [w.launches for w in pf.KERNEL_WRAPPERS] == before


def test_window_ideal_wrappers_refuse_other_devices():
    m = torch.zeros(4, dtype=torch.int32, device="meta")
    m2 = torch.zeros(4, 160, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pf._composition_ideals(m, m2, m, m, m, m, RW=192, n_shift=24)
    with pytest.raises(ValueError):
        pf._span_intersections(m, m2, m, m, SA=1024, n_shift=24)
    c = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        pf._span_intersections(c, m2, c, c, SA=1024, n_shift=24)
    with pytest.raises(ValueError):
        pf._window_sketches(m, m, m, m, SQ=160)
    with pytest.raises(ValueError):
        pf._window_sketches(c, c, m, c, SQ=160)


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
    """``csrc/window_sketches.cu`` row by row: the gathered keys (the
    first SQ of the window, an index past the keys clamped) sorted by the
    bitonic network over the next power of two above their count, then
    the warp's compaction, 32 lanes a step: a key is kept where it is not
    INF and differs from its left neighbour, and lands at the kept keys of
    the earlier steps plus the kept lanes below it (ballot and popc)."""
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
    """The kernel's sort network and ballot compaction against the plain
    version's two row sorts, on the edge windows, at SQ 160 and 48."""
    q_keys, qws, qwe = _sketch_inputs(seed)
    lut = relaxed_jaccard_table(320, K, DEFAULT).astype(np.int32)
    T = torch.from_numpy
    for SQ in (160, 48):
        want = pf._window_sketches_torch(T(q_keys), T(qws), T(qwe),
                                         T(lut), SQ=SQ)
        for g, w in zip(window_sketches_model(q_keys, qws, qwe, lut, SQ),
                        want):
            np.testing.assert_array_equal(g, w.numpy())
