"""The direct fill's plan (``wf.fill_plan``) and the schedules it chooses
among, run on the CPU.

* ``fill_plan`` over classes and batch sizes: organisation, cluster size
  C, lanes a block W, lanes a thread, problems a block; what the kernels do
  not take raises ``ValueError``.
* The cluster fill run as the direct fill (``csrc/tile_fill_cluster.cu``'s
  whole-matrix mode: from the zero state over all S_q + S_t - 1 rows, an odd
  count included, no checkpoint): the NumPy model of
  ``tests/test_torch_tile_cluster.py`` (lane split, seam rings poisoned after
  their one legal read, N-row skew, both extreme block orders) writing
  direction rows, against ``wavefront_fill_torch`` on the band.
* The owned-lane fill (``csrc/fill_owned.cuh``): a NumPy model of one block
  per problem and four lanes a thread: u and y in place, x and v in two
  row-parity planes, the rows in which a thread's group meets the band, its
  threads run in a random order inside a row (a block barrier separates
  rows, nothing orders the threads of one), undefined state outside.
* The warp fill (``csrc/wavefront_fill.cu``): a NumPy model of one warp per
  problem and several problems a block, statement by statement where the
  schedule is concerned: the block's shared query codes (poisoned outside a
  warp's own slice), the registers of 32 threads of four lanes, the value a
  thread takes from its warp neighbour, the travelling query codes, the top
  row found by ``t0 + k == r``, the rows in which a thread stores, and the
  single-byte stores where S_t is no multiple of 4.

Tolerance: exact equality (integer DP)."""

import numpy as np
import pytest
import torch

import test_torch_tile_cluster as tc
from sedef_tpu_torch.ops import wavefront as wf

torch.set_num_threads(1)

WILD = 4
SCORE = (5, -4, 40, 1)
POISON = 99  # a code outside the alphabet: shared memory a warp must not read


# (S_q, S_t, B, sms) -> (org, C, W, lanes, per_block)
@pytest.mark.parametrize("shape,want", [
    ((128, 128, 32, 132), ("warp", 1, 128, 4, 4)),
    ((128, 128, 256, 132), ("warp", 1, 128, 4, 4)),
    ((128, 128, 4096, 132), ("warp", 1, 128, 4, 4)),
    ((128, 128, 40, 4), ("warp", 1, 128, 4, 4)),       # a small card
    ((96, 20, 7, 132), ("warp", 1, 128, 4, 4)),
    ((100000, 128, 9, 132), ("warp", 1, 128, 4, 2)),   # codes of 2 fit
    ((2048, 128, 64, 132), ("warp", 1, 128, 4, 4)),
    ((61440, 96, 4096, 132), ("warp", 1, 128, 4, 3)),  # codes of 3 fit
    ((1, 1, 1, 132), ("warp", 1, 128, 4, 4)),
    ((128, 132, 32, 132), ("owned", 1, 132, 4, 1)),    # one group too many
    ((256, 256, 64, 132), ("owned", 1, 256, 4, 1)),
    ((1024, 1024, 1, 132), ("owned", 1, 1024, 4, 1)),
    ((1024, 1024, 64, 132), ("owned", 1, 1024, 4, 1)),
    ((1024, 1024, 1056, 132), ("owned", 1, 1024, 4, 1)),
    ((256, 1024, 64, 132), ("owned", 1, 1024, 4, 1)),
    ((2048, 512, 64, 132), ("owned", 1, 512, 4, 1)),
    ((2048, 2048, 32, 132), ("owned", 1, 2048, 4, 1)),
    ((10240, 2048, 2, 132), ("owned", 1, 2048, 4, 1)),
    ((3, 300, 2, 132), ("owned", 1, 300, 4, 1)),       # any S_q
    ((4096, 4096, 100, 132), ("owned", 1, 4096, 4, 1)),  # a block each anyway
    ((4096, 4096, 67, 132), ("owned", 1, 4096, 4, 1)),    # 134 blocks
    ((4096, 4096, 17, 132), ("cluster", 4, 1024, 2, 1)),
    ((128, 129, 32, 132), ("cluster", 1, 132, 1, 1)),  # no whole 4-lane groups
    ((1024, 1030, 64, 132), ("cluster", 2, 516, 2, 1)),
    ((4096, 4096, 4, 132), ("cluster", 16, 256, 1, 1)),
    ((4096, 4096, 16, 132), ("cluster", 8, 512, 2, 1)),
    ((2052, 2052, 8, 132), ("cluster", 8, 260, 1, 1)),  # W stays >= 256
    ((8192, 8192, 2, 132), ("cluster", 16, 512, 2, 1)),
    ((8192, 8192, 40, 132), ("cluster", 2, 4096, 4, 1)),  # what lanes need
    ((61440, 61440, 1, 132), ("cluster", 16, 3840, 4, 1)),
    ((4096, 4096, 2, 16), ("cluster", 8, 512, 2, 1)),   # a 16-SM card
    ((2, 8192, 40, 132), ("cluster", 4, 2048, 2, 1)),   # S_q caps the lanes
    ((1, 5000, 500, 132), ("cluster", 8, 628, 1, 1)),
])
def test_fill_plan_derives_the_organisation(shape, want):
    S_q, S_t, B, sms = shape
    plan = wf.fill_plan(S_q, S_t, B, sms)
    assert (plan.org, plan.C, plan.W, plan.lanes, plan.per_block) == want
    assert plan.org in wf.FILL_ORGS
    if plan.org == "warp":
        assert S_t <= wf.FILL_WARP_LANES and plan.N == 0
        assert plan.per_block * S_q <= wf.FILL_SMEM_BYTES
    elif plan.org == "owned":
        assert S_t % 4 == 0 and S_t <= wf.FILL_OWNED_MAX_W and plan.N == 4
        assert 24 * S_t + S_q <= wf.FILL_SMEM_BYTES
        assert S_t <= wf.FILL_OWNED_WIDEST or B * 2 > sms or S_t // 2 < 256
    else:
        assert plan.lanes <= S_q
        assert plan.C * plan.W >= S_t and plan.W % 4 == 0
        assert plan.W <= wf.TILE_THREADS * plan.lanes
        assert plan.tile == wf.TilePlan(plan.C, plan.W, plan.lanes, plan.N,
                                        plan.ring)
        assert plan.tile.smem_bytes <= wf.FILL_SMEM_BYTES
        assert plan.ring > 2 * plan.N
        # no more blocks than SMs, unless the lanes (or a short query's
        # narrow threads) need them
        assert (B * plan.C <= sms or plan.C == wf.tile_min_cluster(S_t)
                or plan.W * 2 > wf.TILE_THREADS * min(S_q, 4))


@pytest.mark.parametrize("shape,force,want", [
    ((128, 128, 9), dict(org="owned"), ("owned", 1, 128, 4, 1)),
    ((128, 128, 9), dict(org="cluster"), ("cluster", 1, 128, 1, 1)),
    ((128, 128, 9), dict(org="cluster", lanes=4), ("cluster", 1, 128, 4, 1)),
    ((128, 128, 9), dict(C=4), ("cluster", 4, 32, 1, 1)),
    ((128, 128, 9), dict(org="warp", per_block=1), ("warp", 1, 128, 4, 1)),
    ((128, 128, 9), dict(org="warp", per_block=32), ("warp", 1, 128, 4, 32)),
    ((1024, 1024, 64), dict(org="cluster"), ("cluster", 2, 512, 2, 1)),
    ((1024, 1024, 64), dict(C=1), ("cluster", 1, 1024, 2, 1)),
    ((1024, 1024, 64), dict(lanes=4), ("cluster", 2, 512, 4, 1)),
    ((1024, 1024, 64), dict(C=8), ("cluster", 8, 128, 1, 1)),
    ((1024, 1024, 1056), dict(org="cluster"), ("cluster", 1, 1024, 2, 1)),
    ((8192, 8192, 2), dict(C=4, lanes=4), ("cluster", 4, 2048, 4, 1)),
    ((8192, 8192, 2), dict(org="cluster", N=8), ("cluster", 16, 512, 2, 1)),
    ((4096, 4096, 4), dict(org="owned"), ("owned", 1, 4096, 4, 1)),
    ((256, 1024, 4), dict(org="owned", N=2), ("owned", 1, 1024, 4, 1)),
])
def test_fill_plan_forced(shape, force, want):
    plan = wf.fill_plan(*shape, 132, **force)
    assert (plan.org, plan.C, plan.W, plan.lanes, plan.per_block) == want
    assert plan.N == force.get("N", {"warp": 0, "owned": 4}.get(
        plan.org, wf.TILE_ROWS_PER_BARRIER))


@pytest.mark.parametrize("shape,force", [
    ((128, 129, 4), dict(org="warp")),            # 129 lanes in a warp
    ((128, 128, 4), dict(org="warp", C=2)),
    ((128, 128, 4), dict(org="warp", lanes=2)),
    ((128, 128, 4), dict(org="warp", N=8)),
    ((128, 128, 4), dict(org="warp", per_block=33)),
    ((128, 128, 4), dict(org="warp", per_block=0)),
    ((61440, 128, 4), dict(org="warp", per_block=4)),  # 240 KB of codes
    ((128, 128, 4), dict(org="owned", C=2)),
    ((128, 128, 4), dict(org="owned", lanes=2)),
    ((128, 128, 4), dict(org="owned", N=8)),
    ((128, 128, 4), dict(org="owned", per_block=4)),
    ((128, 130, 4), dict(org="owned")),           # no whole 4-lane groups
    ((128, 128, 4), dict(org="cluster", per_block=2)),
    ((128, 128, 4), dict(org="rows")),
    ((8192, 8192, 2), dict(org="owned")),         # 8192 lanes in one block
    ((200000, 4096, 2), dict(org="owned")),       # the query beside 96 KB
    ((8192, 8192, 2), dict(C=1)),
    ((8192, 8192, 2), dict(C=3)),
    ((8192, 8192, 2), dict(C=16, N=3)),
    ((8192, 8192, 2), dict(C=2, lanes=2)),        # 4096 lanes, 1024 threads
    ((2, 8192, 2), dict(C=2)),                    # 4 lanes a thread, S_q = 2
    ((2, 1026, 2), dict(lanes=4)),
    ((0, 128, 4), {}), ((128, 0, 4), {}), ((128, 128, 0), {}),
    ((128, 16 * 4096 + 1, 1), {}),                # wider than 16 blocks hold
])
def test_fill_plan_rejects(shape, force):
    with pytest.raises(ValueError):
        wf.fill_plan(*shape, 132, **force)


def test_fill_plan_rejects_a_card_without_sms():
    with pytest.raises(ValueError):
        wf.fill_plan(128, 128, 4, 0)


def test_wavefront_fill_takes_a_plan_and_ignores_it_on_the_cpu():
    """``plan=`` is keyword-only; on CPU tensors the wrapper runs the plain
    fill and counts no launch."""
    rng = np.random.default_rng(1)
    q, t = (torch.from_numpy(a) for a in tc._problem(rng, 40, 56, 3))
    n0 = wf.wavefront_fill.launches
    want = wf.wavefront_fill_torch(q, t)
    for force in (dict(org="warp"), dict(org="owned"), dict(C=2)):
        plan = wf.fill_plan(40, 56, 3, 132, **force)
        assert torch.equal(wf.wavefront_fill(q, t, plan=plan), want)
    assert wf.wavefront_fill.launches == n0
    with pytest.raises(TypeError):
        wf.wavefront_fill(q, t, 5, -4, 40, 1, plan)


# ---------------------------------------------------------------------------
# The cluster fill as the direct fill
# ---------------------------------------------------------------------------

def full_fill(q, t, plan, order, score=SCORE):
    """All S_q + S_t - 1 direction rows of one problem (q (1, S_q), t (1,
    S_t)) under ``plan``, from undefined state (a lane's first band row is
    its top row, which injects the boundary): (n_rows, S_t), 255 where
    nothing was written.  Steps and block orders as ``tc.cluster_fill``."""
    S_q, S_t = q.shape[1], t.shape[1]
    n_rows = S_q + S_t - 1
    blocks = [tc.Block(c, plan, q, t, 0, n_rows, None) for c in range(plan.C)]
    p_out = np.full((n_rows, S_t), 255, np.int64)
    turn = (range(plan.C) if order == "senders"
            else range(plan.C - 1, -1, -1))
    for st in range(tc.tile_steps(n_rows, plan)):
        for c in turn:
            b = blocks[c]
            R0 = (st - c) * plan.N
            for r in range(max(R0, b.rows[0]), min(R0 + plan.N, b.rows[1])):
                b.run_row(r, blocks[c + 1] if c + 1 < plan.C else None,
                          p_out, *score)
    return p_out


# (S_q, S_t, forced plan): odd and even row counts; one block at 1, 2 and
# 4 lanes a thread; clusters whose last block is short or
# empty; S_t no multiple of 4; S_q of one and two codes; a barrier per row
FULL_CASES = [(96, 96, dict(C=1, lanes=4)), (96, 97, dict(C=1, lanes=2)),
              (64, 129, dict(C=1, lanes=1)),
              (64, 128, dict(C=2)), (65, 128, dict(C=2, lanes=4)),
              (160, 64, dict(C=4, N=2)), (64, 160, dict(C=4, N=8)),
              (100, 131, dict(C=4, lanes=2, N=4)),
              (40, 256, dict(C=8, N=4, lanes=4)),
              (33, 72, dict(C=16, N=8)), (120, 121, dict(C=4, N=1)),
              (1, 70, dict(C=1)), (2, 70, dict(C=2, lanes=2)),
              (1, 1, dict(C=1)), (7, 300, dict(C=2, N=32))]


@pytest.mark.parametrize("order", ["senders", "receivers"])
@pytest.mark.parametrize("S_q,S_t,force", FULL_CASES)
def test_cluster_fill_as_direct_fill_matches_plain(S_q, S_t, force, order):
    rng = np.random.default_rng(S_q * 11 + S_t)
    q, t = tc._problem(rng, S_q, S_t)
    plan = wf.fill_plan(S_q, S_t, 1, 132, org="cluster", **force)
    assert plan.org == "cluster" and plan.lanes <= S_q
    got = full_fill(q, t, plan.tile, order)
    want = wf.wavefront_fill_torch(torch.from_numpy(q),
                                   torch.from_numpy(t))[0].numpy()
    band = wf.stream_band(0, S_q + S_t - 1, S_q, S_t).numpy()
    np.testing.assert_array_equal(got[band], want[band])


# ---------------------------------------------------------------------------
# The owned-lane fill
# ---------------------------------------------------------------------------

GARBAGE = 1 << 20


def owned_fill(q, t, rng, score=SCORE):
    """The owned-lane fill of one problem (q (S_q,), t (S_t,) int8, S_t a
    multiple of 4): (n_rows, S_t), 255 where nothing was written.  The
    kernel zeroes its planes; here they start as garbage, which a band cell
    must never read."""
    match, mis, gapo, gape = score
    S_q, S_t = len(q), len(t)
    LPT = wf.FILL_OWNED_LANES
    assert S_t % LPT == 0
    n_rows = S_q + S_t - 1
    U = np.full(S_t, GARBAGE, np.int64)
    Y = U.copy()
    X = np.full((2, S_t), GARBAGE, np.int64)
    V = X.copy()
    p = np.full((n_rows, S_t), 255, np.int64)
    for r in range(n_rows):
        par = r & 1
        for g in rng.permutation(S_t // LPT):
            t0 = g * LPT
            if not (t0 <= r and t0 + LPT - 1 >= r - S_q + 1):
                continue
            xl = np.concatenate([[0], X[par ^ 1, t0:t0 + LPT - 1]])
            vl = np.concatenate([[gapo if r > 0 else 0],
                                 V[par ^ 1, t0:t0 + LPT - 1]])
            if t0 > 0:
                xl[0], vl[0] = X[par ^ 1, t0 - 1], V[par ^ 1, t0 - 1]
            for k in range(LPT):
                lane, j = t0 + k, r - t0 - k
                qc = q[j] if 0 <= j < S_q else WILD
                ub, yb = U[lane], Y[lane]
                if lane == r:
                    ub, yb = (gapo if lane > 0 else 0), 0
                wild = t[lane] >= WILD or qc >= WILD
                sc = 0 if wild else (match if qc == t[lane] else mis)
                (p[r, lane], U[lane], V[par, lane], X[par, lane],
                 Y[lane]) = _cell(sc, xl[k], vl[k], ub, yb, *score)
    return p


@pytest.mark.parametrize("S_q,S_t", [(96, 96), (97, 96), (33, 132), (130, 36),
                                     (1, 40), (3, 8), (64, 4)])
def test_owned_fill_matches_plain(S_q, S_t):
    rng = np.random.default_rng(S_q * 13 + S_t)
    q, t = tc._problem(rng, S_q, S_t)
    plan = wf.fill_plan(S_q, S_t, 1, 132, org="owned")
    assert (plan.W, plan.lanes, plan.N) == (S_t, 4, 4)
    got = owned_fill(q[0], t[0], rng)
    want = wf.wavefront_fill_torch(torch.from_numpy(q),
                                   torch.from_numpy(t))[0].numpy()
    band = wf.stream_band(0, S_q + S_t - 1, S_q, S_t).numpy()
    np.testing.assert_array_equal(got[band], want[band])


# ---------------------------------------------------------------------------
# The warp fill
# ---------------------------------------------------------------------------

def _cell(sc, xs, vs, ub, yb, match, mis, gapo, gape):
    qe2 = 2 * (gapo + gape)
    z = sc + qe2
    a, b = xs + vs, yb + ub
    d = int(a > z)
    z = max(z, a)
    d = 2 if b > z else d
    z = min(max(z, b), match + qe2)
    a2, b2 = a - (z - gapo), b - (z - gapo)
    d |= (int(a2 > 0) << 3) | (int(b2 > 0) << 4)
    return d, z - vs, z - ub, max(a2, 0), max(b2, 0)   # d, u, v, x, y


def warp_fill(qseq, tgt, per_block, score=SCORE):
    """The warp fill of a batch (qseq (B, S_q), tgt (B, S_t) int8): blocks
    of ``per_block`` warps, warp w of block k on problem k * per_block + w;
    (B, n_rows, S_t), 255 where nothing was written."""
    match, mis, gapo, gape = score
    B, S_q = qseq.shape
    S_t = tgt.shape[1]
    assert S_t <= wf.FILL_WARP_LANES
    LPT = 4
    n_rows = S_q + S_t - 1
    vec = S_t % LPT == 0
    p = np.full((B, n_rows, S_t), 255, np.int64)
    for blk in range(-(-B // per_block)):
        smem = np.full(per_block * S_q, POISON, np.int64)
        for warp in range(per_block):
            b = blk * per_block + warp
            if b >= B:
                continue
            qs = smem[warp * S_q:(warp + 1) * S_q]   # a view: the warp's own
            qs[:] = qseq[b]
            t0 = LPT * np.arange(32)
            lane = t0[:, None] + np.arange(LPT)
            tcode = np.where(lane < S_t, tgt[b][np.minimum(lane, S_t - 1)],
                             WILD)
            u = np.zeros((32, LPT), np.int64)
            y, x, v = u.copy(), u.copy(), u.copy()
            qc = np.full((32, LPT), WILD, np.int64)
            qnext = np.where(t0 == 0, qs[0], WILD)
            for r in range(n_rows):
                # __shfl_up_sync by one: thread ln - 1's last lane
                xl = np.concatenate([[0], x[:-1, LPT - 1]])
                vl = np.concatenate([[gapo if r > 0 else 0],
                                     v[:-1, LPT - 1]])
                qc = np.concatenate([qnext[:, None], qc[:, :LPT - 1]], axis=1)
                jn = r + 1 - t0
                qnext = np.where((jn >= 0) & (jn < S_q),
                                 qs[np.clip(jn, 0, S_q - 1)], WILD)
                assert POISON not in qnext
                word = np.zeros((32, LPT), np.int64)
                for ln in range(32):
                    for k in range(LPT - 1, -1, -1):   # descending
                        xs = x[ln, k - 1] if k else xl[ln]
                        vs = v[ln, k - 1] if k else vl[ln]
                        ub, yb = u[ln, k], y[ln, k]
                        if t0[ln] + k == r:
                            ub, yb = (gapo if t0[ln] + k > 0 else 0), 0
                        wild = tcode[ln, k] >= WILD or qc[ln, k] >= WILD
                        sc = 0 if wild else (
                            match if qc[ln, k] == tcode[ln, k] else mis)
                        (word[ln, k], u[ln, k], v[ln, k], x[ln, k],
                         y[ln, k]) = _cell(sc, xs, vs, ub, yb, *score)
                    if (t0[ln] <= r and t0[ln] + LPT - 1 >= r - S_q + 1
                            and t0[ln] < S_t):
                        if vec:
                            p[b, r, t0[ln]:t0[ln] + LPT] = word[ln]
                        else:
                            for k in range(LPT):
                                if t0[ln] + k < S_t:
                                    p[b, r, t0[ln] + k] = word[ln, k]
    return p


# (S_q, S_t, B, problems a block): the class itself; a batch that leaves
# warps of the last block idle; S_t no multiple of 4 (single-byte stores)
# and shorter than a thread's lanes; S_q of one and of three codes; S_q
# longer than S_t
@pytest.mark.parametrize("S_q,S_t,B,per_block", [
    (128, 128, 2, 4), (40, 36, 9, 4), (33, 30, 10, 8), (24, 31, 3, 1),
    (1, 17, 5, 4), (3, 128, 5, 8), (60, 3, 6, 4), (50, 1, 3, 2),
    (90, 45, 5, 3)])
def test_warp_fill_matches_plain(S_q, S_t, B, per_block):
    rng = np.random.default_rng(S_q * 3 + S_t + B)
    qs, ts = zip(*(tc._problem(rng, S_q, S_t) for _ in range(B)))
    q, t = np.concatenate(qs), np.concatenate(ts)
    plan = wf.fill_plan(S_q, S_t, B, 132, org="warp", per_block=per_block)
    got = warp_fill(q, t, plan.per_block)
    want = wf.wavefront_fill_torch(torch.from_numpy(q),
                                   torch.from_numpy(t)).numpy()
    band = wf.stream_band(0, S_q + S_t - 1, S_q, S_t).numpy()
    for b in range(B):
        np.testing.assert_array_equal(got[b][band], want[b][band])


@pytest.mark.parametrize("K", [1, 2])
def test_plain_checkpoint_pass_also_writes_the_rows(K):
    """``tile_checkpoint_torch(p_out=)``: one plain pass gives the
    checkpoints and the direction rows of the plain fills."""
    rng = np.random.default_rng(K)
    q, t = (torch.from_numpy(a) for a in tc._problem(rng, 40, 56, 2 * K))
    p = torch.empty((2, K * 40 + 55, 56), dtype=torch.uint8)
    ck = wf.tile_checkpoint_torch(q, t, 16, K, p_out=p)
    assert torch.equal(ck, wf.tile_checkpoint_torch(q, t, 16, K))
    assert torch.equal(p, wf.wavefront_fill_streamed_torch(q, t, K))
