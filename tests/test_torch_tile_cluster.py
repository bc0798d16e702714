"""The schedule of the cluster tile fill (``csrc/tile_fill_cluster.cu``),
run on the CPU: a NumPy model of the lane split over C blocks, the seam
rings and the N-row skew, held against the plain versions
``tile_checkpoint_torch`` / ``tile_refill_torch`` on band lanes, and the
pure-Python functions that derive the plan.

The model follows the kernel statement by statement where the schedule is
concerned: which rows a block and a thread's group of lanes run
(``tile_block_rows``, the group's own range), the travelling query codes
and the counter that finds a lane's top row and its problem in a stream of
K, the ring slot a seam value is written to and read from, the step a
block runs a row in (``tile_steps``).  What the card does in parallel the model
does in the two extreme orders a cluster barrier allows: inside a step
every sender before its receiver, or every receiver before its sender.
A seam slot is poisoned after its one legal read and every lane the
kernel leaves undefined holds garbage, so a value read too late, too
early, or from outside the band wrecks a band cell and shows.

Tolerance: exact equality (integer DP)."""

import numpy as np
import pytest
import torch

from sedef_tpu_torch.ops import wavefront as wf

torch.set_num_threads(1)

WILD = 4
POISON = -(1 << 40)   # a seam slot after its last legal read
GARBAGE = 1 << 20     # state the kernel leaves undefined
SCORE = (5, -4, 40, 1)


class PoisonRead(AssertionError):
    pass


def tile_steps(rows: int, plan) -> int:
    """Cluster-barrier steps of a launch over ``rows`` rows: the last block
    starts C - 1 steps after the first."""
    return -(-rows // plan.N) + plan.C - 1


def tile_block_rows(c: int, plan, Q: int, S_t: int, r0: int, r1: int):
    """Rows [lo, hi) of [r0, r1) in which block c does work, for a stream
    of Q = K * S_q query codes: those in which its lanes meet the band, and
    one more (the checkpoint of the row after a lane's last band row is
    that lane's)."""
    lane_lo = c * plan.W
    lane_hi = min(lane_lo + plan.W, S_t) - 1
    lo = max(r0, lane_lo)
    return (lo, lo) if lane_hi < lane_lo else (lo, min(r1, Q + lane_hi + 1))


def _problem(rng, S_q, S_t, K=1):
    """One stream: q (K, S_q), t (K, S_t) int8, each target sharing 80% of
    its query's codes, a few wildcards."""
    q = rng.integers(0, 4, (K, S_q)).astype(np.int8)
    t = rng.integers(0, 4, (K, S_t)).astype(np.int8)
    n = min(S_q, S_t)
    keep = rng.random((K, n)) < 0.8
    t[:, :n][keep] = q[:, :n][keep]
    q[rng.random((K, S_q)) < 0.03] = WILD
    return q, t


def _code(q, j):
    """q[j], the wildcard outside the query."""
    j = np.asarray(j)
    ok = (j >= 0) & (j < len(q))
    return np.where(ok, q[np.clip(j, 0, len(q) - 1)], WILD).astype(np.int64)


class Block:
    """One block of the cluster: W lanes of state, its inbound seam rings,
    and per 4-lane group (a thread) the travelling query codes."""

    def __init__(self, c, plan, q, t, r0, r1, ck_in):
        self.c, self.plan = c, plan
        W, LPT = plan.W, plan.lanes
        (K, S_q), S_t = q.shape, t.shape[1]
        Q = K * S_q
        self.q, self.t, self.r0 = q.reshape(-1), t, r0
        self.K, self.S_q, self.S_t, self.Q = K, S_q, S_t, Q
        self.lanes = c * W + np.arange(W)
        self.U = np.full(W, GARBAGE, np.int64)
        self.Y = np.full(W, GARBAGE, np.int64)
        self.X = np.full((2, W), GARBAGE, np.int64)
        self.V = np.full((2, W), GARBAGE, np.int64)
        self.RX = np.full(plan.ring, POISON, np.int64)
        self.RV = np.full(plan.ring, POISON, np.int64)
        self.t0 = c * W + LPT * np.arange(W // LPT)       # per group
        self.mine = self.t0 < S_t
        if ck_in is not None:  # a refill: the tile's checkpoint, by lane
            ok = self.lanes < S_t
            src = self.lanes[ok]
            self.U[ok], self.Y[ok] = ck_in[0, src], ck_in[1, src]
            self.X[1, ok], self.V[1, ok] = ck_in[2, src], ck_in[3, src]
            if c > 0 and c * W < S_t:
                slot = (r0 - 1) & (plan.ring - 1)
                self.RX[slot] = ck_in[2, c * W - 1]
                self.RV[slot] = ck_in[3, c * W - 1]
        self.rows = tile_block_rows(c, plan, Q, S_t, r0, r1)
        self.th_r0 = np.maximum(r0, self.t0)
        self.th_r1 = np.where(self.mine,
                              np.minimum(r1, Q + self.t0 + LPT - 1),
                              self.th_r0)
        # the travelling state as each group's first row finds it
        k = np.arange(LPT)
        m0 = self.th_r0 - self.t0
        self.kk0, self.j0 = m0 // S_q, m0 % S_q
        self.qc = _code(self.q, m0[:, None] - 1 - k)
        self.qnext = _code(self.q, m0)
        kk = np.where(self.j0[:, None] >= k, self.kk0[:, None],
                      np.maximum(self.kk0[:, None] - 1, 0))
        self.tc = self._target(kk, self.lanes.reshape(-1, LPT))

    def _target(self, kk, lane):
        """The target code of ``lane`` in problem ``kk`` (the wildcard past
        the stream's problems and past S_t)."""
        ok = (kk < self.K) & (lane < self.S_t)
        return np.where(ok, self.t[np.minimum(kk, self.K - 1),
                                   np.minimum(lane, self.S_t - 1)],
                        WILD).astype(np.int64)

    def run_row(self, r, nxt, p_out, match, mis, gapo, gape):
        """Row r: the groups whose lanes meet the band compute their four
        cells; ``nxt`` is block c + 1 (None for the last)."""
        plan, W, Q = self.plan, self.plan.W, self.Q
        LPT = plan.lanes
        act = (r >= self.th_r0) & (r < self.th_r1)
        if not act.any():
            return
        par = r & 1
        # the travelling codes: shift by one lane, one new code per group
        self.qc[act] = np.concatenate(
            [self.qnext[act, None], self.qc[act, :LPT - 1]], axis=1)
        self.qnext[act] = _code(self.q, r + 1 - self.t0[act])
        # a lane on its top row enters problem kk0: its target code
        top = act[:, None] & (self.j0[:, None] == np.arange(LPT))
        self.tc[top] = self._target(
            np.broadcast_to(self.kk0[:, None], top.shape)[top],
            self.lanes.reshape(-1, LPT)[top])
        top = top.reshape(-1)
        lane_act = np.repeat(act, LPT)
        l = np.nonzero(lane_act)[0]
        t = self.lanes[l]
        Xp, Vp = self.X[par ^ 1], self.V[par ^ 1]
        xs = Xp[np.maximum(l - 1, 0)].copy()
        vs = Vp[np.maximum(l - 1, 0)].copy()
        if l[0] == 0:
            if self.c > 0:
                slot = (r - 1) & (plan.ring - 1)
                xs[0], vs[0] = self.RX[slot], self.RV[slot]
                self.RX[slot] = self.RV[slot] = POISON
                if 0 <= r - t[0] < Q and POISON in (xs[0], vs[0]):
                    raise PoisonRead(f"block {self.c} row {r}: the seam of "
                                     f"row {r - 1} is not in its slot")
            else:
                xs[0], vs[0] = 0, (gapo if self.j0[0] > 0 else 0)
        ub, yb = self.U[l].copy(), self.Y[l].copy()
        top = top[l]
        ub[top] = np.where(t[top] > 0, gapo, 0)
        yb[top] = 0
        qc = self.qc.reshape(-1)[l]
        tc = self.tc.reshape(-1)[l]
        sc = np.where((qc >= WILD) | (tc >= WILD), 0,
                      np.where(qc == tc, match, mis))
        qe2 = 2 * (gapo + gape)
        z = sc + qe2
        a, b = xs + vs, yb + ub
        d = (a > z).astype(np.int64)
        z = np.maximum(z, a)
        d = np.where(b > z, 2, d)
        z = np.minimum(np.maximum(z, b), match + qe2)
        a2, b2 = a - (z - gapo), b - (z - gapo)
        self.U[l], self.V[par, l] = z - vs, z - ub
        self.X[par, l], self.Y[l] = np.maximum(a2, 0), np.maximum(b2, 0)
        d |= ((a2 > 0) << 3) | ((b2 > 0) << 4)
        if nxt is not None and lane_act[W - 1]:
            slot = r & (plan.ring - 1)
            nxt.RX[slot], nxt.RV[slot] = self.X[par, W - 1], self.V[par, W - 1]
        if p_out is not None:
            ok = t < self.S_t
            p_out[r - self.r0, t[ok]] = d[ok] & 0xFF
        self.j0[act] += 1
        wrap = act & (self.j0 == self.S_q)
        self.j0[wrap] = 0
        self.kk0[wrap] += 1

    def store_ckpt(self, r, ck_out):
        ok = np.repeat(self.mine, self.plan.lanes) & (self.lanes < self.S_t)
        dst = self.lanes[ok]
        pp = (r & 1) ^ 1
        for pl, src in enumerate((self.U, self.Y, self.X[pp], self.V[pp])):
            ck_out[pl, dst] = src[ok]


def cluster_fill(q, t, plan, tile, r0, r1, ck_in, order, score=SCORE):
    """Rows [r0, r1) of one stream (q (K, S_q), t (K, S_t)) under
    ``plan``.  ``ck_in`` None: the checkpoint pass from row 0, returns the
    planes (n_tiles, 4, S_t); else a refill from the planes ``ck_in``,
    returns the rows (r1 - r0, S_t), 255 where nothing was written.
    ``order``: "senders" (block 0 first inside a step) or "receivers" (the
    last block first)."""
    (K, S_q), S_t = q.shape, t.shape[1]
    C, N = plan.C, plan.N
    blocks = [Block(c, plan, q, t, r0, r1, ck_in) for c in range(C)]
    refill = ck_in is not None
    p_out = np.full((r1 - r0, S_t), 255, np.int64) if refill else None
    n_tiles = -(-(K * S_q + S_t - 1) // tile)
    ck_out = None if refill else np.full((n_tiles, 4, S_t), GARBAGE, np.int64)
    next_ck = [-(-b.rows[0] // tile) * tile for b in blocks]
    turn = range(C) if order == "senders" else range(C - 1, -1, -1)
    for st in range(tile_steps(r1 - r0, plan)):
        for c in turn:   # between two cluster barriers, in any order
            b = blocks[c]
            R0 = r0 + (st - c) * N
            for r in range(max(R0, b.rows[0]), min(R0 + N, b.rows[1])):
                if not refill and r == next_ck[c]:
                    b.store_ckpt(r, ck_out[r // tile])
                    next_ck[c] += tile
                b.run_row(r, blocks[c + 1] if c + 1 < C else None, p_out,
                          *score)
    return p_out if refill else ck_out


def _reference(q, t, tile):
    K = q.shape[0]
    qt, tt = torch.from_numpy(q), torch.from_numpy(t)
    return qt, tt, wf.tile_checkpoint_torch(qt, tt, tile, K)


def _ckpt_band(ti, tile, S_q, S_t, K):
    """Lanes on which the planes entering tile ti are defined: the band of
    the row before."""
    return wf.stream_band(ti * tile - 1, ti * tile, S_q, S_t, K)[0].numpy()


def _wrong_ckpt_words(ck, ck_ref, tile, S_q, S_t, K):
    return sum(int((ck[ti][:, band] != ck_ref[0, ti].numpy()[:, band]).sum())
               for ti in range(1, ck_ref.shape[1])
               for band in [_ckpt_band(ti, tile, S_q, S_t, K)])


def _garbage_outside_band(ck, tile, S_q, S_t, K):
    """The reference's checkpoint with every lane the kernel leaves
    undefined (outside the band of the row before the tile) overwritten."""
    ck = ck[0].numpy().astype(np.int64)
    for ti in range(ck.shape[0]):
        ck[ti][:, ~_ckpt_band(ti, tile, S_q, S_t, K)] = GARBAGE
    return ck


# (S_q, S_t, K, C, N, tile, lanes a thread): C = 1; S_t not a multiple of
# 4 * C (the last block short, then a partial 4-lane group); S_t < S_q and
# S_t > S_q; wide clusters whose far blocks have no band cell in the first
# tiles and whose near blocks have none in the last; a barrier per row;
# blocks without lanes; streams of K = 2 and 3 problems (a lane passes from
# one problem to the next at its top row), with S_t < S_q and S_t > S_q;
# threads of 1, 2 and 4 lanes
CASES = [(96, 96, 1, 1, 8, 32, 4), (96, 96, 1, 1, 1, 32, 1),
         (64, 128, 1, 2, 8, 64, 4), (160, 64, 1, 4, 2, 32, 2),
         (64, 160, 1, 4, 8, 32, 4), (100, 132, 1, 4, 4, 64, 1),
         (80, 131, 1, 4, 8, 32, 4), (80, 131, 1, 4, 8, 32, 2),
         (40, 256, 1, 8, 4, 32, 4), (48, 192, 1, 16, 2, 32, 1),
         (120, 120, 1, 4, 1, 24, 4), (33, 72, 1, 16, 8, 16, 4),
         (128, 96, 1, 2, 32, 64, 2), (64, 64, 2, 1, 8, 32, 4),
         (96, 64, 3, 4, 4, 64, 1), (40, 128, 2, 8, 2, 32, 4),
         (50, 70, 3, 2, 1, 20, 2)]


@pytest.mark.parametrize("order", ["senders", "receivers"])
@pytest.mark.parametrize("S_q,S_t,K,C,N,tile,lanes", CASES)
def test_cluster_schedule_matches_plain(S_q, S_t, K, C, N, tile, lanes,
                                        order):
    """Checkpoint pass, then every tile's refill (the first and the last
    included), equal to the plain versions on every band lane."""
    rng = np.random.default_rng(S_q * 7 + S_t + C + N + K)
    q, t = _problem(rng, S_q, S_t, K)
    plan = wf.tile_plan(S_t, 1, 132, N=N, C=C, lanes=lanes)
    assert plan.C == C and plan.W % 4 == 0 and plan.C * plan.W >= S_t
    assert plan.ring > 2 * N and plan.lanes == lanes
    Q = K * S_q
    n_rows = Q + S_t - 1
    qt, tt, ck_ref = _reference(q, t, tile)
    ck = cluster_fill(q, t, plan, tile, 0, n_rows, None, order)
    n_tiles = ck_ref.shape[1]
    assert ck.shape == (n_tiles, 4, S_t)
    assert _wrong_ckpt_words(ck, ck_ref, tile, S_q, S_t, K) == 0
    ck_in = _garbage_outside_band(ck_ref, tile, S_q, S_t, K)
    idle = 0
    for ti in range(n_tiles):
        r0, r1 = ti * tile, min((ti + 1) * tile, n_rows)
        idle += sum(lo >= hi for lo, hi in (
            tile_block_rows(c, plan, Q, S_t, r0, r1) for c in range(C)))
        got = cluster_fill(q, t, plan, tile, r0, r1, ck_in[ti], order)
        want = wf.tile_refill_torch(qt, tt, ck_ref, ti, tile, K)[0].numpy()
        band = wf.stream_band(r0, r1, S_q, S_t, K).numpy()
        np.testing.assert_array_equal(got[band], want[:r1 - r0][band])
    if C >= 4:  # some block sits a whole tile out
        assert idle > 0


@pytest.mark.parametrize("S_q,S_t,K,C,N,tile", [(64, 128, 1, 2, 8, 64),
                                                (48, 192, 1, 16, 2, 32),
                                                (40, 128, 2, 8, 2, 32)])
def test_ring_of_2n_slots_is_one_too_few(S_q, S_t, K, C, N, tile):
    """2 N + 1 rows are live at a seam during a step: with 2 N slots a
    sender that runs its step before its receiver overwrites the slot of
    the row before the receiver's first.  The plan's ring holds them."""
    rng = np.random.default_rng(5)
    q, t = _problem(rng, S_q, S_t, K)
    plan = wf.tile_plan(S_t, 1, 132, N=N, C=C)
    n_rows = K * S_q + S_t - 1
    short = plan._replace(ring=2 * N)
    _, _, ck_ref = _reference(q, t, tile)

    def wrong_words(plan, order):
        return _wrong_ckpt_words(
            cluster_fill(q, t, plan, tile, 0, n_rows, None, order), ck_ref,
            tile, S_q, S_t, K)

    assert wrong_words(plan, "senders") == 0
    try:  # the overwritten slot gives wrong words, or is found poisoned
        assert wrong_words(short, "senders") > 0
    except PoisonRead:
        pass
    # receivers first, nothing is overwritten before it is read
    assert wrong_words(short, "receivers") == 0


def test_a_receiver_ahead_of_the_skew_reads_poison():
    """Without the N-row skew (every block on the same rows in a step) a
    receiver that runs first finds its seam slot still poisoned."""
    rng = np.random.default_rng(6)
    q, t = _problem(rng, 64, 128)
    plan = wf.tile_plan(128, 1, 132, N=8, C=2)
    flat = plan._replace(N=10 ** 6)  # every row in one step: no skew
    with pytest.raises(PoisonRead):
        cluster_fill(q, t, flat, 64, 0, 64 + 128 - 1, None, "receivers")


@pytest.mark.parametrize("S_t,n,sms,want", [
    (10240, 4, 132, (16, 640, 2)),    # the 10 Kbp class of <= 8 problems
    (10240, 8, 132, (16, 640, 2)),    # eight streams of a streamed class
    (10240, 16, 132, (8, 1280, 2)),   # no more blocks than SMs
    (61440, 1, 132, (16, 3840, 4)),   # a 60 Kbp chunk
    (4096, 4, 132, (16, 256, 1)),     # the narrowest giant class
    (2048, 2, 132, (8, 256, 1)),      # a block keeps 256 lanes
    (256, 6, 132, (1, 256, 1)),
    (300, 1, 132, (1, 300, 1)),
    (1028, 1, 132, (4, 260, 1)),      # W rounds up to whole 4-lane groups
    (10240, 102, 132, (4, 2560, 4)),  # many problems: what the lanes need
    (20480, 1, 4, (8, 2560, 4)),      # a small card: the same
    (8192, 1, 8, (8, 1024, 2)),
    (8192, 1, 132, (16, 512, 2)),     # two lanes a thread from W = 512 on
    (6144, 1, 132, (16, 384, 1)),
    (8192, 40, 132, (2, 4096, 4)),
])
def test_tile_plan_derives_the_cluster(S_t, n, sms, want):
    plan = wf.tile_plan(S_t, n, sms)
    assert (plan.C, plan.W, plan.lanes) == want
    assert plan.W <= wf.TILE_THREADS * plan.lanes
    assert plan.N == wf.TILE_ROWS_PER_BARRIER
    assert plan.ring > 2 * plan.N and plan.ring & (plan.ring - 1) == 0
    assert plan.C * plan.W >= S_t and plan.W <= wf.TILE_MAX_W
    assert plan.C == wf.tile_min_cluster(S_t) or (
        n * plan.C <= sms and -(-S_t // plan.C) >= wf.TILE_MIN_W)
    assert plan.smem_bytes <= 227 * 1024


def test_tile_plan_rejects():
    with pytest.raises(ValueError):
        wf.tile_plan(16 * 4096 + 1, 1, 132)       # wider than 16 blocks hold
    with pytest.raises(ValueError):
        wf.tile_plan(10240, 1, 132, C=2)          # 5120 lanes in a block
    with pytest.raises(ValueError):
        wf.tile_plan(1024, 1, 132, C=3)           # not a power of two
    with pytest.raises(ValueError):
        wf.tile_plan(1024, 1, 132, N=3)           # odd rows per barrier
    with pytest.raises(ValueError):
        wf.tile_plan(0, 1, 132)
    with pytest.raises(ValueError):
        wf.tile_plan(10240, 1, 132, C=4, lanes=2)  # 2560 lanes, 1024 threads
    with pytest.raises(ValueError):
        wf.tile_plan(1024, 1, 132, lanes=3)
    assert wf.tile_plan(1024, 1, 132, N=1).ring == 4
    assert wf.tile_plan(1024, 1, 132, N=32, C=16) == wf.TilePlan(16, 64, 1,
                                                                 32, 128)
    assert wf.tile_plan(1024, 1, 132, C=16, lanes=4).lanes == 4


@pytest.mark.parametrize("rows,C,N,steps", [(4096, 8, 32, 135),
                                            (4096, 1, 16, 256),
                                            (20479, 16, 16, 1295),
                                            (30719, 16, 32, 975),
                                            (5, 4, 8, 4), (17, 2, 1, 18)])
def test_tile_steps(rows, C, N, steps):
    plan = wf.tile_plan(4096, 1, 132, N=N, C=C)
    assert tile_steps(rows, plan) == steps


def test_tile_block_rows_cover_the_band():
    """Every band cell of a block's lanes lies in the block's rows, for
    every tile; a block without lanes has none."""
    S_q, S_t, tile = 40, 100, 16
    plan = wf.tile_plan(S_t, 1, 132, N=4, C=8)    # W = 16: block 7 is empty
    n_rows = S_q + S_t - 1
    for r0 in range(0, n_rows, tile):
        r1 = min(r0 + tile, n_rows)
        band = wf.stream_band(r0, r1, S_q, S_t).numpy()
        for c in range(plan.C):
            lo, hi = tile_block_rows(c, plan, S_q, S_t, r0, r1)
            mine = band[:, c * plan.W:(c + 1) * plan.W]
            rows = r0 + np.nonzero(mine.any(axis=1))[0]
            if len(rows):
                assert lo <= rows.min() and rows.max() < hi
            if c * plan.W >= S_t:
                assert lo == hi


def test_wrappers_take_a_plan_and_ignore_it_on_the_cpu():
    """``plan=`` is keyword-only; on CPU tensors the wrappers run the plain
    versions and count no launch."""
    rng = np.random.default_rng(2)
    q, t = _problem(rng, 64, 96)
    qt, tt = torch.from_numpy(q), torch.from_numpy(t)
    plan = wf.tile_plan(96, 1, 132, C=2)
    n0 = (wf.tile_checkpoint.launches, wf.tile_refill.launches)
    ck = wf.tile_checkpoint(qt, tt, 32, plan=plan)
    assert torch.equal(ck, wf.tile_checkpoint_torch(qt, tt, 32))
    pt = wf.tile_refill(qt, tt, ck, 1, 32, plan=plan)
    band = wf.stream_band(32, 64, 64, 96)
    assert torch.equal(pt[0][band],
                       wf.tile_refill_torch(qt, tt, ck, 1, 32)[0][band])
    assert (wf.tile_checkpoint.launches, wf.tile_refill.launches) == n0
    with pytest.raises(TypeError):
        wf.tile_checkpoint(qt, tt, 32, 5, -4, 40, 1, plan)
    q2, t2 = (torch.from_numpy(a) for a in _problem(rng, 64, 96, 2))
    n0 = (wf.tile_checkpoint_streamed.launches,
          wf.tile_refill_streamed.launches)
    ck = wf.tile_checkpoint_streamed(q2, t2, 2, 32, plan=plan)
    assert torch.equal(ck, wf.tile_checkpoint_torch(q2, t2, 32, 2))
    wf.tile_refill_streamed(q2, t2, ck, 0, 2, 32, plan=plan)
    assert (wf.tile_checkpoint_streamed.launches,
            wf.tile_refill_streamed.launches) == n0
