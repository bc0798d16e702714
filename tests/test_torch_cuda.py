"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one; the file
imports neither jax nor sedef_tpu, so it runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: exact equality (integer DP, byte-for-byte ops and CIGARs)."""

import numpy as np
import pytest
import torch

from sedef_tpu_torch.ops import wavefront as wf

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _batch(rng, S_q, S_t, B):
    qs = np.full((B, S_q), 4, np.int8)
    ts = np.full((B, S_t), 4, np.int8)
    ql = rng.integers(1, S_q + 1, B).astype(np.int32)
    tl = rng.integers(1, S_t + 1, B).astype(np.int32)
    pairs = []
    for b in range(B):
        q = rng.integers(0, 5, ql[b]).astype(np.int8)
        t = rng.integers(0, 5, tl[b]).astype(np.int8)
        n = min(ql[b], tl[b]) // 2
        t[:n] = q[:n]
        qs[b, :ql[b]] = q
        ts[b, :tl[b]] = t
        pairs.append((q, t))
    return qs, ts, ql, tl, pairs


# the card's own plan: a warp per problem at 128 lanes, one block of owned
# lanes at the wider classes
@pytest.mark.parametrize("S_q,S_t,B", [(128, 128, 40), (256, 1024, 9),
                                       (2048, 512, 5), (10240, 2048, 2)])
def test_kernels_match_plain(dev, S_q, S_t, B):
    rng = np.random.default_rng(S_q + S_t + B)
    qs, ts, ql, tl, _ = _batch(rng, S_q, S_t, B)
    q, t = torch.from_numpy(qs).to(dev), torch.from_numpy(ts).to(dev)
    qlt, tlt = torch.from_numpy(ql).to(dev), torch.from_numpy(tl).to(dev)
    n0 = (wf.wavefront_fill.launches, wf.backtrack_pack.launches)
    p_k = wf.wavefront_fill(q, t)
    p_p = wf.wavefront_fill_torch(q, t)
    for b in range(B):
        r = torch.arange(S_q + S_t - 1, device=dev)[:, None]
        lane = torch.arange(S_t, device=dev)[None, :]
        m = (lane >= r - int(ql[b]) + 1) & (lane <= r) & (lane < int(tl[b]))
        m &= r < int(ql[b] + tl[b] - 1)
        assert torch.equal(p_k[b][m], p_p[b][m]), b
    o_k = wf.backtrack_pack(p_k, qlt, tlt)
    o_p = wf.backtrack_pack_torch(p_k, qlt, tlt)
    torch.cuda.synchronize()
    assert torch.equal(o_k, o_p)
    assert (wf.wavefront_fill.launches, wf.backtrack_pack.launches) == (
        n0[0] + 1, n0[1] + 1)


def test_cuda_aligner_matches_numpy(dev):
    rng = np.random.default_rng(9)
    _, _, _, _, pairs = _batch(rng, 512, 512, 24)
    al = wf.WavefrontAligner(device="cuda")
    al.DEVICE_BATCH_MIN = 1
    al.DEVICE_BATCH_MIN_CELLS = 0
    got = al.align_batch(pairs)
    assert al.device_problems == len(pairs)
    for (q, t), cig in zip(pairs, got):
        p, _ = wf.wavefront_np(q, t)
        assert cig == wf.backtrack_np(p, len(q), len(t))


@pytest.mark.parametrize("variant", wf.FILL_VARIANTS)
def test_fill_variant_matches_plain(dev, variant):
    """Every variant writes the plain fill's bytes on every band lane, on
    ragged problems (lengths below the class, wildcards) and on classes
    with S_q != S_t, at every class of the list it takes; each call is one
    launch."""
    from sedef_tpu_torch.tools import kbench
    for S_q, S_t, B in [(128, 128, 9), (512, 1024, 4), (1024, 256, 3),
                        (384, 132, 2)]:
        if not kbench.variant_takes(variant, S_t):
            continue
        rng = np.random.default_rng(S_q + S_t + B)
        qs, ts, _, _, _ = _batch(rng, S_q, S_t, B)
        q, t = _on_card(dev, qs, ts)
        n0 = wf.wavefront_fill_variant.launches
        p = wf.wavefront_fill_variant(variant, q, t)
        torch.cuda.synchronize()
        assert wf.wavefront_fill_variant.launches == n0 + 1
        _assert_band_equal(p, wf.wavefront_fill_torch(q, t), 0, S_q, S_t, 1)


def test_fill_variant_golden_and_errors(dev):
    from sedef_tpu_torch.tools import kbench
    for variant in wf.FILL_VARIANTS:
        assert kbench.check_correct(variant, dev), variant
    q = torch.zeros((2, 128), dtype=torch.int8, device=dev)
    t = torch.zeros((2, 130), dtype=torch.int8, device=dev)
    n0 = wf.wavefront_fill_variant.launches
    with pytest.raises(ValueError):
        wf.wavefront_fill_variant("reg", q, t)
    with pytest.raises(ValueError):
        wf.wavefront_fill_variant("nope", q, q)
    assert wf.wavefront_fill_variant.launches == n0


@pytest.mark.parametrize("variant", sorted(wf.VARIANT_CLUSTER))
@pytest.mark.parametrize("S_q,S_t,B", [(700, 1024, 3), (2048, 512, 2),
                                       (96, 4096, 1), (1536, 2048, 2)])
def test_cluster_variant_ragged_few_problems(dev, variant, S_q, S_t, B):
    """A cluster variant on ragged problems (S_q != S_t, lengths below
    the class, wildcards) at a batch below the card's SM count: one launch,
    0 band mismatches against the plain fill, and a cluster the card
    holds."""
    assert B * wf.VARIANT_CLUSTER[variant] < torch.cuda.get_device_properties(
        dev).multi_processor_count
    assert wf.fill_variant_clusters(variant, S_q, S_t, dev) > 0
    rng = np.random.default_rng(S_q * 3 + S_t + B)
    qs, ts, _, _, _ = _batch(rng, S_q, S_t, B)
    q, t = _on_card(dev, qs, ts)
    n0 = wf.wavefront_fill_variant.launches
    p = wf.wavefront_fill_variant(variant, q, t)
    torch.cuda.synchronize()
    assert wf.wavefront_fill_variant.launches == n0 + 1
    _assert_band_equal(p, wf.wavefront_fill_torch(q, t), 0, S_q, S_t, 1)


def test_cluster_variant_that_cannot_be_held_raises(dev):
    """A cluster whose blocks no SM can hold (the query of 240,000 codes
    is kept in each block's shared memory) is refused: the occupancy says
    0, the wrapper raises and counts no launch; it does not shrink the
    cluster or fall back to another variant."""
    q = torch.zeros((1, 240000), dtype=torch.int8, device=dev)
    t = torch.zeros((1, 256), dtype=torch.int8, device=dev)
    n0 = wf.wavefront_fill_variant.launches
    for variant in sorted(wf.VARIANT_CLUSTER):
        assert wf.fill_variant_clusters(variant, 240000, 256, dev) == 0
        with pytest.raises(RuntimeError):
            wf.wavefront_fill_variant(variant, q, t)
    torch.cuda.synchronize()
    assert wf.wavefront_fill_variant.launches == n0


def _on_card(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _assert_band_equal(pa, pb, r0, S_q, S_t, K):
    """Equal bytes on every lane the kernels write (stream_band)."""
    m = wf.stream_band(r0, r0 + pa.shape[1], S_q, S_t, K, pa.device)
    for s in range(pa.shape[0]):
        assert torch.equal(pa[s][m], pb[s][m]), s


# streams of 2 to 16 problems with S_q < S_t, S_q = S_t and S_q > S_t; a
# class wider than one block (2048, 10240); S_q = 128 under 1,024 lanes in
# streams of 16; a width no multiple of 4 (1030) for the cluster paths
STREAM_CASES = [(1024, 1024, 2, 5), (128, 512, 3, 4), (2048, 1024, 16, 2),
                (2048, 10240, 2, 2), (128, 1024, 16, 2), (300, 1030, 3, 3)]
# the card's own plan, "parallel" over owned lanes and over a cluster (C
# from 1 to 4 here), and "chain"
STREAM_FORCES = {"own": {}, "owned": dict(kernel="owned"),
                 "cluster": dict(kernel="cluster"), "chain": dict(org="chain")}


@pytest.mark.parametrize("S_q,S_t,K,n,force", [
    pytest.param(*case, force, id=f"{case}-{name}")
    for case in STREAM_CASES for name, force in STREAM_FORCES.items()
    if not (name == "owned" and (case[1] % 4 or case[1] > 4096))])
def test_streamed_fill_matches_plain(dev, S_q, S_t, K, n, force):
    """The streamed fill under every organisation writes the plain
    version's bytes on every band lane in one launch, and its traceback
    gives the plain traceback's and the direct route's packed ops."""
    rng = np.random.default_rng(S_q + S_t + K)
    qs, ts, ql, tl, pairs = _batch(rng, S_q, S_t, n * K)
    q, t, qlt, tlt = _on_card(dev, qs, ts, ql, tl)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = wf.stream_plan(S_q, S_t, n, K, sms, **force) if force else None
    n0 = (wf.wavefront_fill_streamed.launches, wf.backtrack_pack.launches)
    p_k = wf.wavefront_fill_streamed(q, t, K, plan=plan)
    _assert_band_equal(p_k, wf.wavefront_fill_streamed_torch(q, t, K), 0,
                       S_q, S_t, K)
    o_k = wf.backtrack_pack(p_k, qlt, tlt, K)
    assert torch.equal(o_k, wf.backtrack_pack_torch(p_k, qlt, tlt, K))
    assert (wf.wavefront_fill_streamed.launches,
            wf.backtrack_pack.launches) == (n0[0] + 1, n0[1] + 1)
    assert torch.equal(o_k, wf.backtrack_pack(wf.wavefront_fill(q, t), qlt,
                                              tlt))
    if S_t <= 1024:
        ops = o_k.cpu().numpy()
        for b, (qq, tt) in enumerate(pairs[:4]):
            p_np, _ = wf.wavefront_np(qq, tt)
            assert (wf.cigar_from_packed_ops(ops[b], len(qq), len(tt))
                    == wf.backtrack_np(p_np, len(qq), len(tt))), b


def test_stream_plan_on_and_refused_streamed_fill_raise(dev):
    """The card's own plan is "parallel" under a kernel the card takes; a
    plan the kernels refuse raises and counts no launch."""
    for S_q, S_t, n, K in [(2048, 2048, 25, 2), (1024, 1024, 132, 8),
                           (4096, 4096, 25, 2), (8192, 8192, 17, 2)]:
        plan = wf.stream_plan_on(dev, S_q, S_t, n, K)
        assert plan.org == "parallel"
        if plan.fill.C > 1:
            assert wf.tile_cluster_occupancy(plan.fill.tile, n * K, 3,
                                             dev) >= 1
    q = torch.zeros((4, 512), dtype=torch.int8, device=dev)
    odd = torch.zeros((4, 2050), dtype=torch.int8, device=dev)
    n0 = wf.wavefront_fill_streamed.launches
    with pytest.raises(RuntimeError):   # owned lanes come in fours
        wf.wavefront_fill_streamed(q, odd, 2, plan=wf.StreamPlan(
            "parallel", wf.FillPlan("owned", 1, 2050, 4, 4, 0, 1)))
    with pytest.raises(RuntimeError):   # a cluster of 32 blocks
        wf.wavefront_fill_streamed(q, odd, 2, plan=wf.StreamPlan(
            "chain", wf.FillPlan("cluster", 32, 68, 1, 16, 64, 1)))
    torch.cuda.synchronize()
    assert wf.wavefront_fill_streamed.launches == n0


# the cluster tile fill splits a stream over C blocks: C = 1 at (256,256), 2
# at (1024,512), 16 at (1024,9216) and (4096,4096), 8 at (8192,2048);
# (640,1036) and (512,2050) have S_t no multiple of 4 * C, the second no
# multiple of 4
@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("S_q,S_t,K,n,tile", [(256, 256, 3, 2, 128),
                                              (1024, 512, 2, 3, 1024),
                                              (1024, 9216, 1, 2, 4096),
                                              (4096, 4096, 1, 2, 4096),
                                              (8192, 2048, 1, 3, 4096),
                                              (640, 1036, 1, 3, 256),
                                              (512, 2050, 1, 2, 1024)])
def test_tiled_kernels_match_plain(dev, streamed, S_q, S_t, K, n, tile):
    """Checkpoint, refill and tile traceback each against their plain
    versions on the same inputs, and the tiled route's packed ops against
    the direct route's."""
    if streamed and K == 1:
        K = 2
    if not streamed:
        n, K = n * K, 1
    rng = np.random.default_rng(S_q * 3 + S_t + K)
    qs, ts, ql, tl, _ = _batch(rng, S_q, S_t, n * K)
    q, t, qlt, tlt = _on_card(dev, qs, ts, ql, tl)
    if streamed:
        ckpt_fn, refill, walk = (wf.tile_checkpoint_streamed,
                                 wf.tile_refill_streamed,
                                 wf.tile_backtrack_streamed)
        ck_k = ckpt_fn(q, t, K, tile)
    else:
        ckpt_fn, refill, walk = (wf.tile_checkpoint, wf.tile_refill,
                                 wf.tile_backtrack)
        ck_k = ckpt_fn(q, t, tile)
    n0 = [w.launches for w in (ckpt_fn, refill, walk)]
    ck_p = wf.tile_checkpoint_torch(q, t, tile, K)
    for ti in range(1, ck_k.shape[1]):
        m = wf.stream_band(ti * tile - 1, ti * tile, S_q, S_t, K, dev)[0]
        assert torch.equal(ck_k[:, ti][:, :, m], ck_p[:, ti][:, :, m]), ti
    ws_k = torch.stack([tlt - 1, qlt - 1, torch.zeros_like(qlt)], 1)
    ws_p = ws_k.clone()
    out_k = torch.empty((n * K, (S_q + S_t + 2) // 4), dtype=torch.uint8,
                        device=dev)
    out_p = out_k.clone()
    n_rows = K * S_q + S_t - 1
    for ti in range(ck_k.shape[1] - 1, -1, -1):
        args = (K, tile) if streamed else (tile,)
        pt = refill(q, t, ck_k, ti, *args)
        rows = min(tile, n_rows - ti * tile)
        _assert_band_equal(pt[:, :rows],
                           wf.tile_refill_torch(q, t, ck_k, ti, tile,
                                                K)[:, :rows],
                           ti * tile, S_q, S_t, K)
        wargs = (ti * tile, S_q, K) if streamed else (ti * tile, S_q)
        walk(pt, qlt, tlt, ws_k, out_k, *wargs)
        wf.tile_backtrack_torch(pt, qlt, tlt, ws_p, out_p, ti * tile, S_q, K)
        assert torch.equal(ws_k, ws_p) and torch.equal(out_k, out_p), ti
    n_tiles = ck_k.shape[1]
    assert [w.launches for w in (ckpt_fn, refill, walk)] == [
        n0[0], n0[1] + n_tiles, n0[2] + n_tiles]
    direct = wf.backtrack_pack(wf.wavefront_fill(q, t), qlt, tlt)
    assert torch.equal(out_k, direct)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("C,N,lanes", [(1, 1, 2), (1, 16, 4), (2, 2, 1),
                                       (4, 8, 2), (8, 32, 1), (16, 16, 4),
                                       (16, 1, 1), (2, 32, 4), (8, 8, 2)])
def test_cluster_tile_fill_under_every_plan(dev, C, N, lanes, K):
    """The checkpoint pass and the refill under forced plans (cluster size
    C, rows per cluster barrier N, lanes a thread), plain and over streams
    of K, write the plain versions' band bytes; each call is one launch."""
    S_q, S_t, tile, n = 1536, 2048, 512, 3
    rng = np.random.default_rng(C * 100 + N + K + lanes)
    qs, ts, _, _, _ = _batch(rng, S_q, S_t, n * K)
    q, t = _on_card(dev, qs, ts)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = wf.tile_plan(S_t, n, sms, N=N, C=C, lanes=lanes)
    assert wf.tile_cluster_occupancy(plan, n, False, dev) >= 1
    assert wf.tile_cluster_occupancy(plan, n, True, dev) >= 1
    if K == 1:
        fns = (wf.tile_checkpoint, wf.tile_refill)
        ck_k = fns[0](q, t, tile, plan=plan)
    else:
        fns = (wf.tile_checkpoint_streamed, wf.tile_refill_streamed)
        ck_k = fns[0](q, t, K, tile, plan=plan)
    n0 = [f.launches for f in fns]
    ck_p = wf.tile_checkpoint_torch(q, t, tile, K)
    for ti in range(1, ck_k.shape[1]):
        m = wf.stream_band(ti * tile - 1, ti * tile, S_q, S_t, K, dev)[0]
        assert torch.equal(ck_k[:, ti][:, :, m], ck_p[:, ti][:, :, m]), ti
    n_rows = K * S_q + S_t - 1
    for ti in range(ck_k.shape[1]):
        args = (ti, tile) if K == 1 else (ti, K, tile)
        pt = fns[1](q, t, ck_k, *args, plan=plan)
        rows = min(tile, n_rows - ti * tile)
        _assert_band_equal(pt[:, :rows],
                           wf.tile_refill_torch(q, t, ck_p, ti, tile,
                                                K)[:, :rows],
                           ti * tile, S_q, S_t, K)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [n0[0], n0[1] + ck_k.shape[1]]


def test_refused_cluster_launch_raises(dev):
    """A cluster the card cannot schedule (32 blocks; the largest is 16)
    never runs: the wrapper raises and counts no launch; it does not fall
    back to another kernel."""
    rng = np.random.default_rng(1)
    qs, ts, _, _, _ = _batch(rng, 512, 2048, 1)
    q, t = _on_card(dev, qs, ts)
    bad = wf.TilePlan(32, 64, 1, 16, 64)
    assert wf.tile_cluster_occupancy(bad, 1, False, dev) == 0
    n0 = (wf.tile_checkpoint.launches, wf.tile_refill.launches)
    with pytest.raises(RuntimeError):
        wf.tile_checkpoint(q, t, 512, plan=bad)
    ck = wf.tile_checkpoint(q, t, 512)
    with pytest.raises(RuntimeError):
        wf.tile_refill(q, t, ck, 0, 512, plan=bad)
    with pytest.raises(RuntimeError):   # 64 lanes a block hold 1024 of 2048
        wf.tile_checkpoint(q, t, 512, plan=wf.TilePlan(16, 64, 1, 16, 64))
    torch.cuda.synchronize()
    assert (wf.tile_checkpoint.launches, wf.tile_refill.launches) == (
        n0[0] + 1, n0[1])
    # a wider class than 16 blocks of 4096 lanes hold raises before launch
    wide = torch.zeros((1, 16 * 4096 + 4), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        wf.tile_checkpoint(q, wide, 512)


# every organisation of the direct fill, forced: a warp per problem (S_t
# no multiple of 4; S_q shorter than a thread's lanes; one and eight
# problems a block), one block of owned lanes (S_q of one and three codes;
# the widest class), the cluster fill as one block (1, 2, 4 lanes a thread)
# and as clusters of 2 to 16 (odd and even row counts; S_t no multiple of
# 4 * C, then of 4)
@pytest.mark.parametrize("S_q,S_t,B,force", [
    (128, 128, 40, dict(org="warp", per_block=4)),
    (100, 90, 37, dict(org="warp", per_block=8)),
    (3, 128, 5, dict(org="warp", per_block=1)),
    (128, 128, 9, dict(org="owned")),
    (256, 1024, 9, dict(org="owned")),
    (1025, 1024, 3, dict(org="owned")),
    (3, 300, 3, dict(org="owned")),
    (1, 132, 2, dict(org="owned")),
    (512, 4096, 2, dict(org="owned")),
    (1024, 1024, 3, dict(org="owned", N=2)),
    (128, 128, 9, dict(org="cluster", C=1, lanes=4)),
    (256, 1024, 9, dict(org="cluster", C=1, lanes=2)),
    (1024, 1024, 3, dict(org="cluster", C=1, lanes=1)),
    (2, 301, 3, dict(org="cluster", C=1, lanes=2)),
    (1, 301, 2, dict(org="cluster")),
    (1024, 1024, 3, dict(org="cluster", C=2)),
    (2048, 512, 5, dict(org="cluster", C=2, lanes=4)),
    (640, 1036, 3, dict(org="cluster", C=4)),
    (512, 2050, 2, dict(org="cluster", C=8, lanes=1)),
    (4096, 4096, 2, dict(org="cluster", C=16)),
    (1024, 1023, 2, dict(org="cluster", C=2, N=2)),
])
def test_direct_fill_under_every_organisation(dev, S_q, S_t, B, force):
    """``plan=`` forces the organisation; each writes the plain fill's
    bytes on every band lane in one launch, and the traceback of its
    matrix equals the plain one's."""
    rng = np.random.default_rng(S_q * 5 + S_t + B)
    qs, ts, ql, tl, _ = _batch(rng, S_q, S_t, B)
    q, t, qlt, tlt = _on_card(dev, qs, ts, ql, tl)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = wf.fill_plan(S_q, S_t, B, sms, **force)
    assert plan.org == force["org"]
    n0 = wf.wavefront_fill.launches
    p = wf.wavefront_fill(q, t, plan=plan)
    torch.cuda.synchronize()
    assert wf.wavefront_fill.launches == n0 + 1
    _assert_band_equal(p, wf.wavefront_fill_torch(q, t), 0, S_q, S_t, 1)
    assert torch.equal(wf.backtrack_pack(p, qlt, tlt),
                       wf.backtrack_pack_torch(p, qlt, tlt))


def test_fill_plan_on_and_refused_fill_raise(dev):
    """The card's own plan names a kernel the card takes; a plan it
    refuses raises and counts no launch."""
    for S_q, S_t, B in [(128, 128, 300), (1024, 1024, 64), (4096, 4096, 8),
                        (8192, 8192, 2), (1024, 1030, 600)]:
        plan = wf.fill_plan_on(dev, S_q, S_t, B)
        assert plan.org in wf.FILL_ORGS
        if plan.C > 1:   # clusters all run at once; single blocks may queue
            assert wf.tile_cluster_occupancy(plan.tile, B, 2, dev) >= B
    q = torch.zeros((2, 512), dtype=torch.int8, device=dev)
    t = torch.zeros((2, 2048), dtype=torch.int8, device=dev)
    n0 = wf.wavefront_fill.launches
    with pytest.raises(RuntimeError):   # a cluster of 32 blocks
        wf.wavefront_fill(q, t, plan=wf.FillPlan("cluster", 32, 64, 1, 16,
                                                 64, 1))
    with pytest.raises(RuntimeError):   # 128 lanes of a warp for 2048
        wf.wavefront_fill(q, t, plan=wf.FillPlan("warp", 1, 128, 4, 0, 0, 4))
    odd = torch.zeros((2, 2050), dtype=torch.int8, device=dev)
    with pytest.raises(RuntimeError):   # owned lanes come in fours
        wf.wavefront_fill(q, odd, plan=wf.FillPlan("owned", 1, 2050, 4, 4, 0,
                                                   1))
    torch.cuda.synchronize()
    assert wf.wavefront_fill.launches == n0
    wide = torch.zeros((1, 16 * 4096 + 4), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        wf.wavefront_fill(q[:1], wide)


WALK_FORCES = [dict(R=0), dict(R=32, prefetch=False), dict(R=32),
               dict(R=32, pw=48), dict(R=64, prefetch=False), dict(R=64),
               dict(R=64, pw=80, warps=3)]


def _skewed(rng, S_q, S_t, B, kind):
    """Problems whose walkers leave on the left edge (tl << ql), on the
    top edge (ql << tl), or random ones."""
    qs, ts, ql, tl, pairs = _batch(rng, S_q, S_t, B)
    if kind == "left":
        tl = np.minimum(tl, rng.integers(1, 12, B)).astype(np.int32)
    elif kind == "top":
        ql = np.minimum(ql, rng.integers(1, 12, B)).astype(np.int32)
    for b in range(B):
        qs[b, ql[b]:] = 4
        ts[b, tl[b]:] = 4
    return qs, ts, ql, tl


# S_t = 1036 is no multiple of 16 (4-byte copies), 514 none of 4 (single
# bytes); (600, 40) and (40, 600) are far from square
@pytest.mark.parametrize("force", WALK_FORCES)
@pytest.mark.parametrize("S_q,S_t,B,K,tile,kind", [
    (512, 512, 7, 1, 128, "random"), (512, 512, 6, 1, 256, "left"),
    (512, 512, 6, 1, 256, "top"), (640, 1036, 3, 1, 256, "random"),
    (300, 514, 4, 2, 64, "random"), (600, 48, 5, 1, 64, "top"),
    (40, 600, 300, 1, 128, "left"), (256, 256, 6, 3, 128, "random")])
def test_walker_under_every_plan(dev, S_q, S_t, B, K, tile, kind, force):
    """The three tracebacks under a forced walk plan: packed ops of the
    whole matrix equal ``backtrack_pack_torch``'s, and every tile's
    walker states and bytes equal ``tile_backtrack_torch``'s."""
    rng = np.random.default_rng(S_q + 3 * S_t + B)
    qs, ts, ql, tl = _skewed(rng, S_q, S_t, B, kind)
    q, t, qlt, tlt = _on_card(dev, qs, ts, ql, tl)
    plan = wf.walk_plan(B, **force)
    p = wf.wavefront_fill_streamed(q, t, K) if K > 1 else wf.wavefront_fill(
        q, t)
    n0 = wf.backtrack_pack.launches
    o_k = wf.backtrack_pack(p, qlt, tlt, K, plan=plan)
    torch.cuda.synchronize()
    assert wf.backtrack_pack.launches == n0 + 1
    assert torch.equal(o_k, wf.backtrack_pack_torch(p, qlt, tlt, K))
    walk = wf.tile_backtrack_streamed if K > 1 else wf.tile_backtrack
    ws_k = torch.stack([tlt - 1, qlt - 1, torch.zeros_like(qlt)], 1)
    ws_p = ws_k.clone()
    out_k = torch.empty_like(o_k)
    out_p = out_k.clone()
    n_rows = p.shape[1]
    n0 = walk.launches
    n_tiles = -(-n_rows // tile)
    for ti in range(n_tiles - 1, -1, -1):
        pt = torch.zeros((p.shape[0], tile, S_t), dtype=torch.uint8,
                         device=dev)
        rows = min(tile, n_rows - ti * tile)
        pt[:, :rows] = p[:, ti * tile:ti * tile + rows]
        wargs = (ti * tile, S_q, K) if K > 1 else (ti * tile, S_q)
        walk(pt, qlt, tlt, ws_k, out_k, *wargs, plan=plan)
        wf.tile_backtrack_torch(pt, qlt, tlt, ws_p, out_p, ti * tile, S_q, K)
        assert torch.equal(ws_k, ws_p) and torch.equal(out_k, out_p), ti
    assert walk.launches == n0 + n_tiles
    assert torch.equal(out_k, o_k)


@pytest.mark.parametrize("force", WALK_FORCES)
def test_walkers_outside_their_problem(dev, force):
    """Walkers handed over beyond their problem's corner (i >= tl or
    j >= ql) take the forced states: the kernel's general loop."""
    S_q, S_t, B, tile = 256, 320, 9, 576
    rng = np.random.default_rng(12)
    qs, ts, ql, tl, _ = _batch(rng, S_q, S_t, B)
    ql, tl = np.minimum(ql, 200), np.minimum(tl, 250)
    q, t, qlt, tlt = _on_card(dev, qs, ts, ql, tl)
    p = torch.zeros((B, tile, S_t), dtype=torch.uint8, device=dev)
    p[:, :S_q + S_t - 1] = wf.wavefront_fill(q, t)
    ws_k = torch.tensor([[tl[b] - 1 + 20 * (b % 3), ql[b] - 1 + 25 * (b % 2),
                          0] for b in range(B)], dtype=torch.int32,
                        device=dev)
    ws_p = ws_k.clone()
    out_k = torch.zeros((B, (S_q + S_t + 2) // 4), dtype=torch.uint8,
                        device=dev)
    out_p = out_k.clone()
    wf.tile_backtrack(p, qlt, tlt, ws_k, out_k, 0, S_q,
                      plan=wf.walk_plan(B, **force))
    wf.tile_backtrack_torch(p, qlt, tlt, ws_p, out_p, 0, S_q)
    assert torch.equal(ws_k, ws_p) and torch.equal(out_k, out_p)


def test_refused_walk_raises(dev):
    """A walk plan the kernel does not take raises; no launch is
    counted."""
    rng = np.random.default_rng(2)
    qs, ts, ql, tl, _ = _batch(rng, 128, 128, 3)
    q, t, qlt, tlt = _on_card(dev, qs, ts, ql, tl)
    p = wf.wavefront_fill(q, t)
    n0 = wf.backtrack_pack.launches
    for bad in (wf.WalkPlan(48, 64, True, 1), wf.WalkPlan(64, 72, True, 1),
                wf.WalkPlan(64, 144, True, 33)):
        with pytest.raises(RuntimeError):
            wf.backtrack_pack(p, qlt, tlt, plan=bad)
    torch.cuda.synchronize()
    assert wf.backtrack_pack.launches == n0


def test_cuda_aligner_takes_every_route(dev):
    """Lowered class thresholds send one batch through the direct,
    streamed, tiled and streamed-tiled routes; every CIGAR equals the
    NumPy reference's and each route launches its kernels."""
    rng = np.random.default_rng(4)
    al = wf.WavefrontAligner(device="cuda")
    al.DEVICE_BATCH_MIN = 1
    al.DEVICE_BATCH_MIN_CELLS = 0
    al.GIANT_S_T = 256      # class 512 is giant: tiled
    al.STREAM_MIN_S_T = 256
    al.STREAM_MIN_PROBLEMS = 4
    al.GIANT_STREAMS = 2
    pairs = []
    for lo, hi, cnt in [(40, 128, 3), (150, 256, 9), (300, 512, 5)]:
        for _ in range(cnt):
            n = int(rng.integers(lo, hi + 1))
            q = rng.integers(0, 4, n).astype(np.int8)
            t = q.copy()
            mut = rng.random(n) < 0.1
            t[mut] = rng.integers(0, 4, int(mut.sum()))
            pairs.append((q, t[:max(1, n - int(rng.integers(0, 20)))]))
    n0 = [w.launches for w in wf.KERNEL_WRAPPERS]
    got = al.align_batch(pairs)
    for (q, t), cig in zip(pairs, got):
        p, _ = wf.wavefront_np(q, t)
        assert cig == wf.backtrack_np(p, len(q), len(t))
    used = [w.__name__ for w, c in zip(wf.KERNEL_WRAPPERS, n0)
            if w.launches > c]
    assert used == ["wavefront_fill", "backtrack_pack",
                    "wavefront_fill_streamed", "tile_checkpoint_streamed",
                    "tile_refill_streamed", "tile_backtrack_streamed"]
    al.GIANT_STREAMS = 8
    n0 = [w.launches for w in wf.KERNEL_WRAPPERS]
    al.align_batch(pairs[-5:])
    assert [w.__name__ for w, c in zip(wf.KERNEL_WRAPPERS, n0)
            if w.launches > c] == ["tile_checkpoint", "tile_refill",
                                   "tile_backtrack"]


def test_launch_follows_the_tensors_device():
    """Tensors on a card other than the current one run on their card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(3)
    qs, ts, ql, tl, _ = _batch(rng, 256, 256, 4)
    d1 = torch.device("cuda", 1)
    q, t, qlt, tlt = _on_card(d1, qs, ts, ql, tl)
    with torch.cuda.device(0):
        o = wf.backtrack_pack(wf.wavefront_fill(q, t), qlt, tlt)
        torch.cuda.synchronize(d1)
    assert o.device == d1
    assert torch.equal(o.cpu(), wf.backtrack_pack_torch(
        wf.wavefront_fill_torch(q.cpu(), t.cpu()), qlt.cpu(), tlt.cpu()))


def test_wrappers_reject_cpu_cuda_mix(dev):
    q = torch.zeros((2, 128), dtype=torch.int8, device=dev)
    t = torch.zeros((2, 128), dtype=torch.int8)
    with pytest.raises(ValueError):
        wf.wavefront_fill(q, t)


def test_mesh_aligner_card_listed_twice(dev):
    """MeshAligner over the card listed twice (two aligners, two host
    threads, two streams) gives the single card aligner's CIGARs; both
    entries fill a shard through kernels 1 and 2."""
    from sedef_tpu_torch.parallel.mesh import MeshAligner
    rng = np.random.default_rng(8)
    pairs = []
    for n in rng.integers(100, 1500, 41):
        q = rng.integers(0, 4, int(n)).astype(np.int8)
        t = q.copy()
        mut = rng.random(int(n)) < 0.1
        t[mut] = rng.integers(0, 4, int(mut.sum()))
        pairs.append((q, t[:int(rng.integers(max(1, n // 2), n + 1))]))
    mesh_al = MeshAligner([dev, dev])
    n0 = (wf.wavefront_fill.launches, wf.backtrack_pack.launches)
    got = mesh_al.align_batch(pairs)
    assert wf.wavefront_fill.launches > n0[0]
    assert wf.backtrack_pack.launches > n0[1]
    assert all(al.device_problems > 0 for al in mesh_al.aligners)
    single = wf.WavefrontAligner(device="cuda")
    single.DEVICE_BATCH_MIN = 1
    single.DEVICE_BATCH_MIN_CELLS = 0
    assert got == single.align_batch(pairs)
    with pytest.raises(RuntimeError):
        MeshAligner([torch.device("cuda", torch.cuda.device_count())])


def test_qgram_scores_on_card(dev):
    from sedef_tpu_torch.parallel.mesh import qgram_scores
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(0, 4, (3, 5, 128)).astype(np.uint8))
    b = a.clone()
    b[:, :, ::9] = 3
    got = qgram_scores(a.to(dev), b.to(dev))
    assert got.device == dev and got.dtype == torch.int32
    assert torch.equal(got.cpu(), qgram_scores(a, b))


# ---- stage 1's device engines: the card against the CPU device and the
# host route

def _stage1_pair(seed, rate=0.2, copies=5):
    """A query and a ref sharing diverged repeat families (fail-heavy
    intervals for the prefilter)."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return "".join(rng.choice(list("ACGT"), n))

    def mutate(s, r):
        return "".join(rand(1) if rng.random() < r else ch for ch in s)

    fams = [rand(800) for _ in range(6)]
    q = "".join(mutate(f, rate * 0.4) + rand(200) for f in fams)
    r = "".join(mutate(f, rate) + rand(150) for f in fams
                for _ in range(copies))
    return q, r


def test_stage1_device_index_on_card(dev):
    from sedef_tpu_torch.ops import dna, winnow_device
    from sedef_tpu_torch.ops.winnow import minimizers_np
    rng = np.random.default_rng(3)
    seq = "".join(rng.choice(list("ACGTacgtN"), 300_000))
    code, cls = dna.encode(seq)
    keys, locs = minimizers_np(code, cls, 12, 16)
    order = np.argsort(keys, kind="stable")
    for seg in (1 << 22, 1 << 15):  # one segment, and ten
        winnow_device._SEG = seg
        try:
            got = winnow_device.device_index_arrays(code, cls, 12, 16, dev)
        finally:
            winnow_device._SEG = 1 << 22
        for g, w in zip(got, (keys, locs, keys[order], locs[order])):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_stage1_prefilter_and_roll_engine_card_equal_cpu(dev):
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.models import seeder
    from sedef_tpu_torch.native import lib as native
    from sedef_tpu_torch.ops import dna
    from sedef_tpu_torch.ops.index import MinimizerIndex
    q, r = _stage1_pair(1)
    qh = MinimizerIndex(dna.PackedSeq("q", q), 12, 16)
    rh = MinimizerIndex(dna.PackedSeq("r", r), 12, 16)
    plan = native.search_plan(qh, rh, False, DEFAULT)
    assert len(plan[1])
    for fn in (seeder._device_prefilter_results,
               seeder._device_roll_results):
        card = fn(qh, rh, plan, DEFAULT, dev)
        cpu = fn(qh, rh, plan, DEFAULT, "cpu")
        for a, b in zip(card, cpu):
            assert a.dtype == b.dtype and np.array_equal(a, b), fn
    assert card[2].all()  # every interval of this plan rolled on the card


def test_stage1_search_with_engines_on_card(dev, monkeypatch):
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.models import seeder
    from sedef_tpu_torch.ops import dna
    from sedef_tpu_torch.ops.index import MinimizerIndex
    q, r = _stage1_pair(2, rate=0.1)
    qh = MinimizerIndex(dna.PackedSeq("q", q), 12, 16)
    rh = MinimizerIndex(dna.PackedSeq("r", r), 12, 16)
    host = [h.to_bed() for h in
            seeder.initial_search(qh, rh, False, DEFAULT, use_device=False)]
    monkeypatch.setattr(seeder, "PREFILTER_ON", True)
    monkeypatch.setattr(seeder, "PREFILTER_MIN_STEPS", 0)
    pre = [h.to_bed() for h in
           seeder.initial_search(qh, rh, False, DEFAULT, use_device=dev)]
    monkeypatch.setattr(seeder, "ROLL_DEVICE_MIN", 0)
    roll = [h.to_bed() for h in
            seeder.initial_search(qh, rh, False, DEFAULT, use_device=dev)]
    assert pre == roll == host and host


def _roll_edge_batch(rng):
    """A soft-masked pair with an N run and the roll engine's edge rows in
    batch-function columns: plan rows, empty query windows in both T
    classes, a window past SQ keys, rows past the 512 class and past the
    ladder."""
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.native import lib as native
    from sedef_tpu_torch.ops import dna
    from sedef_tpu_torch.ops.index import MinimizerIndex

    def rand(n, chars="ACGTacgt"):
        return "".join(rng.choice(list(chars), n))

    base = rand(1800)
    mut = "".join(rand(1) if rng.random() < 0.1 else ch for ch in base)
    q = rand(300) + base + "N" * 30 + base[:400]
    r = rand(500) + mut + "N" * 30 + mut[:400] + rand(4800)
    qh = MinimizerIndex(dna.PackedSeq("q", q), 12, 16)
    rh = MinimizerIndex(dna.PackedSeq("r", r), 12, 16)
    win, iv = native.search_plan(qh, rh, False, DEFAULT)
    woff = np.repeat(np.arange(len(win)), win[:, 3])
    cols = [win[woff, 1], win[woff, 2], iv[:, 0], iv[:, 2], iv[:, 3],
            iv[:, 4], iv[:, 5]]
    rows = [[int(c[i]) for c in cols] for i in range(len(cols[0]))]
    extra = []
    for steps in (300, 3000):
        e = list(rows[0])
        e[1], e[5] = e[0], steps
        extra.append(e)
    e = list(rows[0])
    e[1] = e[0] + 165
    extra.append(e)
    for steps in (600, 4000, 5000):
        e = list(rows[0])
        e[5] = steps
        extra.append(e)
    cols = [np.asarray(c, np.int32) for c in zip(*(rows + extra))]
    return qh, rh, cols


@pytest.mark.parametrize("T_PAD,W,SQ", [(512, 512, 160), (4096, 512, 160),
                                        (4096, 64, 48)])
def test_stage1_roll_kernel_matches_plain(dev, T_PAD, W, SQ):
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.ops import roll_engine as re_
    from sedef_tpu_torch.ops.stat_model import relaxed_jaccard_estimate
    qh, rh, cols = _roll_edge_batch(np.random.default_rng(9))
    lut = torch.tensor([relaxed_jaccard_estimate(s, 12, DEFAULT)
                        for s in range(161)], dtype=torch.int32, device=dev)
    qk, _ = qh.device_arrays(dev)
    rk, rl = rh.device_arrays(dev)
    args = (rk, rl, len(rh.keys), lut, qk,
            *[torch.from_numpy(c).to(dev) for c in cols])
    kw = dict(W=W, SQ=SQ, INIT_PAD=192, T_PAD=T_PAD, n_shift=24)
    before = re_._roll_batch.launches
    got = re_._roll_batch(*args, **kw)
    torch.cuda.synchronize()
    assert re_._roll_batch.launches == before + 1
    want = re_._roll_batch_torch(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert not want[2].all()


@pytest.mark.parametrize("W,SQ", [(512, 160), (64, 48)])
def test_stage1_roll_merged_call_matches_plain(dev, W, SQ):
    """``RollEngine.run`` on the card: one launch over the edge rows and
    rows of every n_steps class edge (1 to 4,097), longest first, equal
    per interval to the plain version batched by class on the card."""
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.ops import roll_engine as re_
    from sedef_tpu_torch.ops.stat_model import relaxed_jaccard_estimate
    qh, rh, cols = _roll_edge_batch(np.random.default_rng(9))
    extra = [1, 511, 512, 513, 2000, 4095, 4096, 4097]
    cols = [np.concatenate([c, np.full(len(extra), c[0], np.int32)])
            for c in cols]
    cols[5][-len(extra):] = extra
    lut = np.array([relaxed_jaccard_estimate(s, 12, DEFAULT)
                    for s in range(161)], np.int32)
    qk, _ = qh.device_arrays(dev)
    rk, rl = rh.device_arrays(dev)
    eng = re_.RollEngine(12, lut, W=W, SQ=SQ)
    before = re_._roll_batch.launches
    got = eng.run(qk, rk, rl, len(rh.keys), len(rh.seq), *cols)
    assert re_._roll_batch.launches == before + 1
    classes = re_._t_classes(cols[5])
    for T in re_.T_PAD_LADDER:
        sel = classes == T
        want = re_._roll_batch_torch(
            rk, rl, len(rh.keys), torch.from_numpy(lut).to(dev), qk,
            *[torch.from_numpy(c[sel]).to(dev) for c in cols], W=W, SQ=SQ,
            INIT_PAD=192, T_PAD=T, n_shift=24)
        for g, w in zip(got, want):
            assert g.dtype == w.cpu().numpy().dtype
            assert np.array_equal(g[sel], w.cpu().numpy())
    assert not got[2][classes == 0].any()
    with pytest.raises(ValueError):
        re_.RollEngine(12, lut, W=128, SQ=SQ).run(
            qk, rk, rl, len(rh.keys), len(rh.seq), *cols)


def _interval_world(rng, n=4000, n_r=60_000, RW=192):
    """Ref loci with wide gaps (spans of no loci), keys from a small
    alphabet with HAS_N keys and duplicate runs, query keys sharing them,
    and plan columns with every edge of the per-interval flow: n_steps 0,
    long spans (past SA, over several tiles), query windows past SQ, empty
    and reversed ones.  As numpy int32 (q_keys, r_keys, r_locs, cols)."""
    gaps = rng.integers(1, 10, n_r)
    gaps[::997] = 500
    r_locs = np.cumsum(gaps).astype(np.int32)
    alphabet = rng.choice(1 << 20, 64, replace=False)
    r_keys = rng.choice(alphabet, n_r).astype(np.int32)
    r_keys[::5] = (2 << 24) | (r_keys[::5] & 0xffff)     # HAS_N
    r_keys[5000:9000:2] = alphabet[3]                     # duplicates
    q_keys = rng.choice(alphabet, 50_000).astype(np.int32)
    q_keys[::7] = r_keys[:50_000:7]
    t0 = rng.integers(0, int(r_locs[-1]) - 8000, n)
    n_steps = rng.integers(0, 400, n)
    n_steps[::5] = 0
    n_steps[1::9] = rng.integers(2000, 7000, len(n_steps[1::9]))
    qws = rng.integers(0, 49_000, n)
    qwe = qws + rng.integers(1, 120, n)
    qwe[2::11] = qws[2::11] + 200                         # past SQ
    qwe[3::13] = qws[3::13] - rng.integers(0, 3, len(qws[3::13]))
    rws0 = np.searchsorted(r_locs, t0)
    cols = np.stack([qws, qwe, t0, rws0, n_steps]).astype(np.int32)
    return q_keys, r_keys, r_locs, cols


@pytest.mark.parametrize("tile", [1024, 16, 3])
def test_stage1_interval_kernel_matches_plain(dev, tile):
    """``csrc/prefilter_intervals.cu`` against ``_interval_verdicts_torch``
    on a repeat-rich pair's plan and on random plans with every edge (RW
    192 and 6, SA 1,024 and 12), one launch each, records equal."""
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.native import lib as native
    from sedef_tpu_torch.ops import dna
    from sedef_tpu_torch.ops import prefilter as pf
    from sedef_tpu_torch.ops.index import MinimizerIndex
    from sedef_tpu_torch.ops.stat_model import relaxed_jaccard_table

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    q, r = _stage1_pair(5)
    qh = MinimizerIndex(dna.PackedSeq("q", q), 12, 16)
    rh = MinimizerIndex(dna.PackedSeq("r", r), 12, 16)
    win, iv = native.search_plan(qh, rh, False, DEFAULT)
    woff = np.repeat(np.arange(len(win)), win[:, 3])
    lut = T(relaxed_jaccard_table(320, 12, DEFAULT))
    L = DEFAULT.search.min_read_size
    qk, _ = qh.device_arrays(dev)
    rk, rl = rh.device_arrays(dev)
    cases = [((qk, rk, rl, lut, T(np.stack([win[woff, 1], win[woff, 2],
                                            iv[:, 0], iv[:, 2],
                                            iv[:, 4]]))),
              dict(L=L, SQ=160, RW=192, SA=1024))]
    rng = np.random.default_rng(tile)
    small = T(np.minimum(np.arange(321) // 5 + 1, 12))
    for RW, SA in ((192, 1024), (6, 12)):
        q_keys, r_keys, r_locs, cols = _interval_world(rng, RW=RW)
        cases.append(((T(q_keys), T(r_keys), T(r_locs), small, T(cols)),
                      dict(L=40, SQ=160, RW=RW, SA=SA)))
    seen = np.zeros(3, bool)
    for args, kw in cases:
        before = pf._interval_verdicts.launches
        got = pf._interval_verdicts(*args, n_shift=24, tile=tile, **kw)
        torch.cuda.synchronize()
        assert pf._interval_verdicts.launches == before + 1
        want = pf._interval_verdicts_torch(*args, n_shift=24, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want), kw
        codes = want[:, 0].cpu().numpy()
        seen |= np.array([(codes == c).any() for c in range(3)])
    assert seen.all()


def test_stage1_device_index_kernel_matches_plain(dev):
    """``csrc/device_index.cu`` against its plain version on one segment
    each: a first and a continuation segment of soft-masked sequence with
    N runs, a homopolymer past cap, nk_valid cut short, k 5 w 1, k 14 w
    40."""
    from sedef_tpu_torch.ops import dna
    from sedef_tpu_torch.ops import winnow_device as wd
    rng = np.random.default_rng(5)
    seq = "".join(rng.choice(list("ACGTacgtN"), 300_000))
    code, cls = dna.encode(seq)
    homo = dna.encode("T" * 50_000)
    cases = [((code, cls), 300_000 - 11, 12, 16, 0),
             ((code, cls), 300_000 - 11, 12, 16, 16),
             (homo, 50_000 - 11, 12, 16, 0),
             ((code, cls), 100_000, 12, 16, 0),
             ((code, cls), 300_000 - 4, 5, 1, 0),
             ((code, cls), 300_000 - 13, 14, 40, 3000)]
    for (c, cl), nk_valid, k, w, drop in cases:
        args = (torch.from_numpy(c).to(dev), torch.from_numpy(cl).to(dev),
                nk_valid, k, w, (len(c) - k + 1) // 6, drop)
        before = wd._device_index.launches
        got = wd._device_index(*args)
        torch.cuda.synchronize()
        assert wd._device_index.launches == before + 1
        want = wd._device_index_torch(*args)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), (k, w, drop)
    assert int(want[0]) > 0 and int(got[0]) > 0


@pytest.mark.parametrize("top,shape", [(4, (3, 5, 128)), (256, (7, 64)),
                                       (5, (16_384, 128)), (4, (9, 5))])
def test_qgram_scores_kernel_matches_plain(dev, top, shape):
    """``csrc/qgram.cu`` against its plain version: codes 0-3, 0-4 and
    0-255, leading dims, one gram a window (W = 5)."""
    from sedef_tpu_torch.parallel import mesh
    rng = np.random.default_rng(top)
    a = rng.integers(0, top, shape).astype(np.uint8)
    b = a.copy()
    flip = rng.random(shape) < 0.1
    b[flip] = rng.integers(0, top, int(flip.sum()))
    a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    before = mesh.qgram_scores.launches
    got = mesh.qgram_scores(a, b)
    torch.cuda.synchronize()
    assert mesh.qgram_scores.launches == before + 1
    want = mesh.qgram_scores_torch(a, b)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_stage1_wrappers_reject_cpu_cuda_mix(dev):
    from sedef_tpu_torch.ops import prefilter as pf
    from sedef_tpu_torch.ops import winnow_device as wd
    from sedef_tpu_torch.parallel import mesh
    g = torch.zeros(64, dtype=torch.int32, device=dev)
    plan = torch.zeros((5, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        pf._interval_verdicts(g, g, g, g, plan, L=40, SQ=160, RW=192,
                              SA=1024, n_shift=24)
    u8 = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError):
        wd._device_index(u8.to(dev), u8, 53, 12, 16, 8)
    with pytest.raises(ValueError):
        mesh.qgram_scores(u8.reshape(4, 16).to(dev), u8.reshape(4, 16))
