"""The windowed walker of ``csrc/traceback_pack.cu``, run on the CPU: a NumPy
model of one warp per walker on patches of R direction rows, held against
the plain versions ``tile_backtrack_torch`` and ``backtrack_pack_torch``, and
the pure-Python ``walk_plan``.

The model follows the kernel statement by statement where the window is
concerned: what a walker of a launch works on (``job_of``: its rows of the
tile, its packed bytes, the stream offset of problem k of K), the first lane
of a patch (``patch_start``), which rows and lanes a fetch copies (none below
the tile's first row, none past S_t, whole copies of V bytes only), the test
that decides whether the patch fetched ahead holds the walker, the rows the
walk of one patch may consume, the byte assembled in a register and stored
when the walker leaves its four rows.  A patch buffer is poisoned before
every fetch, so a byte the walker reads without the warp having fetched it
shows; ``guess_shift`` moves the speculative patch off the walker's path, so
that the refetch (which the kernel needs only for patches narrower than
2 R + 16 bytes) is exercised at every width.

Tolerance: exact equality (packed ops and walker states are integers)."""

import numpy as np
import pytest
import torch

from sedef_tpu_torch.ops import wavefront as wf

torch.set_num_threads(1)

POISON = 0xEE  # no direction byte has bits 5-7 set


class Stats:
    def __init__(self):
        self.fetches = self.hits = self.refetches = self.patches = 0


def patch_start(i, pw, A):
    return max(0, i - (pw - A) + 1) & ~(A - 1)


def fetch_patch(buf, p_rows, lo, S_t, T, a0, V):
    """Rows T, T - 1, ... of the problem (``p_rows[row - lo]``) from lane a0
    into ``buf`` (R, pw), whole copies of V bytes."""
    R, pw = buf.shape
    buf[:] = POISON
    n = min(pw, S_t - a0) // V * V
    for d in range(R):
        row = T - d - lo
        if row < 0:
            continue
        buf[d, :n] = p_rows[row, a0:a0 + n]


def forced(r, i, qlb, tlb):
    st0, en0 = max(0, r - qlb + 1), min(r, tlb - 1)
    return 2 if i < st0 else (1 if i > en0 else -1)


def step(tmp, force, i, j, state):
    s1 = state if state != 0 and (tmp >> (state + 2)) & 1 else tmp & 7
    if force >= 0:
        s1 = force
    op = 0 if s1 == 0 else (2 if s1 == 2 else 1)
    return op, i - (op != 2), j - (op != 1), s1


def window_walk(p, ql, tl, ws, out, r0, S_q, K, R, pw, A=16, prefetch=True,
                guess_shift=0, stats=None):
    """One launch of the window walker over stream rows [r0, r0 + tile) of
    ``p`` (n_streams, tile, S_t) uint8, in place on ``ws`` (B, 3) (None: the
    whole matrix from each problem's corner) and ``out`` (B, n_bytes)."""
    n, tile, S_t = p.shape
    n_diag = S_q + S_t - 1
    stats = stats or Stats()
    V = A if S_t % A == 0 else 1
    for b in range(n * K):
        s, off = b // K, (b % K) * S_q
        lo, hi = max(0, r0 - off), min(n_diag, r0 + tile - off)
        if lo >= hi:
            continue
        out[b, lo >> 2:(hi + 3) >> 2] = 0xFF
        qlb, tlb = int(ql[b]), int(tl[b])
        if not (1 <= qlb <= S_q and 1 <= tlb <= S_t):
            continue
        p_rows = p[s, lo + off - r0:]   # local row lo first
        i, j, state = ((tlb - 1, qlb - 1, 0) if ws is None
                       else (int(x) for x in ws[b]))
        bufs = [np.full((R, pw), POISON, np.int64) for _ in range(2)]
        cur, have_next, cb, acc = 0, False, -1, 0xFF
        T = a0 = Tn = a0n = 0
        while i >= 0 and j >= 0 and i + j >= lo:
            r = i + j
            if (have_next and Tn - R < r <= Tn and a0n <= i < a0n + pw):
                cur ^= 1
                T, a0 = Tn, a0n
                stats.hits += 1
            else:
                stats.refetches += have_next
                T, a0 = r, patch_start(i, pw, A)
                fetch_patch(bufs[cur], p_rows, lo, S_t, T, a0, V)
                stats.fetches += 1
            stats.patches += 1
            have_next = prefetch and T - R >= lo
            if have_next:
                Tn = T - R
                a0n = max(0, patch_start(i, pw, A) + guess_shift) & ~(A - 1)
                fetch_patch(bufs[cur ^ 1], p_rows, lo, S_t, Tn, a0n, V)
            buf = bufs[cur]
            bottom = max(lo, T - R + 1)
            # the kernel's loop without forced states: i and j only fall,
            # so a walker inside its problem stays inside every row's band
            inside = i < tlb and j < qlb
            while i >= 0 and j >= 0:
                rr = i + j
                if rr < bottom or i < a0:
                    break
                if rr >> 2 != cb:
                    if cb >= 0:
                        out[b, cb] = acc
                    cb, acc = rr >> 2, 0xFF
                force = forced(rr, i, qlb, tlb)
                assert force < 0 or not inside
                tmp = 0
                if force < 0:
                    tmp = int(buf[T - rr, i - a0])
                    assert tmp != POISON, (b, rr, i, T, a0)
                op, i, j, state = step(tmp, force, i, j, state)
                sh = 2 * (rr & 3)
                acc = (acc & ~(3 << sh)) | (op << sh)
        if cb >= 0:
            out[b, cb] = acc
        if ws is not None:
            ws[b] = (i, j, state)
    return stats


def _pairs(rng, S_q, S_t, B, kind):
    """(qseq (B, S_q), tgt (B, S_t) int8, ql, tl) of one kind of problem."""
    qs = np.full((B, S_q), 4, np.int8)
    ts = np.full((B, S_t), 4, np.int8)
    ql = rng.integers(max(1, S_q // 2), S_q + 1, B)
    tl = rng.integers(max(1, S_t // 2), S_t + 1, B)
    if kind == "all-I":      # one query code: the target is one insertion
        ql[:] = 1
    elif kind == "all-D":
        tl[:] = 1
    elif kind == "all-M":    # identical sequences
        tl = ql = np.minimum(ql, tl)
    elif kind == "left":     # tl << ql: walkers leave on the left edge
        tl = rng.integers(1, 6, B)
    elif kind == "top":      # ql << tl: on the top edge
        ql = rng.integers(1, 6, B)
    for b in range(B):
        q = rng.integers(0, 4, ql[b])
        if kind == "gap":    # the target lacks a block of the query
            g = min(30, ql[b] // 2)
            at = int(rng.integers(1, ql[b] - g))
            t = np.concatenate([q[:at], q[at + g:]])[:S_t]
            tl[b] = len(t)
        elif kind == "random":
            t = rng.integers(0, 4, tl[b])
        else:
            t = np.resize(q, tl[b])
            if kind not in ("all-M",):
                mut = rng.random(tl[b]) < 0.15
                t = np.where(mut, rng.integers(0, 4, tl[b]), t)
        qs[b, :ql[b]] = q
        ts[b, :tl[b]] = t
    return qs, ts, ql.astype(np.int32), tl.astype(np.int32)


def _fill(qs, ts, K):
    return wf.wavefront_fill_streamed_torch(torch.from_numpy(qs),
                                            torch.from_numpy(ts), K)


KINDS = ["random", "mutated", "all-I", "all-D", "all-M", "left", "top", "gap"]
# (R, pw, alignment, prefetch, guess shift): the kernel's two heights at the
# width whose guess cannot fail, at the narrowest width, without prefetch,
# and with the guess moved off the path; a 4-row patch with 4-byte alignment
WINDOWS = [(64, 144, 16, True, 0), (64, 80, 16, True, 0),
           (64, 144, 16, False, 0), (32, 80, 16, True, 0),
           (32, 48, 16, True, 0), (32, 80, 16, True, 64),
           (32, 80, 16, True, -32), (4, 12, 4, True, 0), (4, 8, 4, True, 0),
           (4, 8, 4, False, 0), (4, 12, 4, True, 8)]


@pytest.mark.parametrize("R,pw,A,prefetch,shift", WINDOWS)
@pytest.mark.parametrize("kind", KINDS)
def test_window_walk_matches_plain_traceback(kind, R, pw, A, prefetch, shift):
    """The whole matrix as one tile, walked from every problem's corner:
    packed ops equal ``backtrack_pack_torch``'s, and the CIGARs of a few
    problems the NumPy reference's."""
    S_q, S_t, B = 72, 88, 5
    rng = np.random.default_rng(len(kind) * 7 + R + pw)
    qs, ts, ql, tl = _pairs(rng, S_q, S_t, B, kind)
    p = _fill(qs, ts, 1)
    want = wf.backtrack_pack_torch(p, torch.from_numpy(ql),
                                   torch.from_numpy(tl)).numpy()
    out = np.zeros_like(want)
    st = window_walk(p.numpy(), ql, tl, None, out, 0, S_q, 1, R, pw, A,
                     prefetch, shift)
    np.testing.assert_array_equal(out, want)
    for b in range(2):
        p_np, _ = wf.wavefront_np(qs[b, :ql[b]], ts[b, :tl[b]])
        assert (wf.cigar_from_packed_ops(out[b], int(ql[b]), int(tl[b]))
                == wf.backtrack_np(p_np, int(ql[b]), int(tl[b])))
    if not prefetch:
        assert st.hits == 0 and st.fetches == st.patches
    elif shift == 0 and pw == 2 * R + A:
        assert st.refetches == 0      # the full-width guess cannot fail
    if shift > 0 and kind in ("random", "mutated", "all-M", "gap"):
        assert st.refetches > 0       # the walker was not where guessed


# (S_q, S_t, K, n_streams, tile; S_q a multiple of 4 where K > 1, as a
# stream offset must be): S_t a multiple of 16, of 4 only and of
# neither (the widths of the copies); streams of K problems whose walkers
# enter a tile at different local rows
@pytest.mark.parametrize("R,pw,A,prefetch,shift", [
    (32, 80, 16, True, 0), (32, 48, 16, True, 0), (64, 144, 16, True, 0),
    (4, 12, 4, True, 0), (4, 8, 4, False, 0), (32, 80, 16, True, 48)])
@pytest.mark.parametrize("S_q,S_t,K,n,tile,kind", [
    (64, 64, 1, 3, 16, "mutated"), (64, 64, 1, 3, 32, "gap"),
    (80, 52, 1, 2, 24, "random"), (52, 70, 2, 2, 20, "mutated"),
    (40, 33, 3, 2, 28, "random"), (72, 88, 1, 3, 36, "left"),
    (72, 88, 1, 3, 36, "top"), (60, 60, 2, 2, 64, "gap")])
def test_window_walk_matches_plain_tile_walk(S_q, S_t, K, n, tile, kind, R,
                                             pw, A, prefetch, shift):
    """Tile by tile from the last to the first: walker states and bytes
    after every tile equal ``tile_backtrack_torch``'s; a walker crosses tile
    boundaries in every state, mid-gap included."""
    B = n * K
    rng = np.random.default_rng(S_q + 5 * S_t + K + tile)
    qs, ts, ql, tl = _pairs(rng, S_q, S_t, B, kind)
    p = _fill(qs, ts, K)
    qlt, tlt = torch.from_numpy(ql), torch.from_numpy(tl)
    n_rows = p.shape[1]
    ws_p = torch.stack([tlt - 1, qlt - 1, torch.zeros_like(qlt)], 1)
    ws_m = ws_p.numpy().copy()
    n_bytes = (S_q + S_t - 1 + 3) // 4
    out_p = torch.zeros((B, n_bytes), dtype=torch.uint8)
    out_m = np.zeros((B, n_bytes), np.uint8)
    in_gap = 0
    for ti in range(-(-n_rows // tile) - 1, -1, -1):
        pt = torch.zeros((n, tile, S_t), dtype=torch.uint8)
        rows = min(tile, n_rows - ti * tile)
        pt[:, :rows] = p[:, ti * tile:ti * tile + rows]
        wf.tile_backtrack_torch(pt, qlt, tlt, ws_p, out_p, ti * tile, S_q, K)
        window_walk(pt.numpy(), ql, tl, ws_m, out_m, ti * tile, S_q, K, R, pw,
                    A, prefetch, shift)
        np.testing.assert_array_equal(ws_m, ws_p.numpy())
        np.testing.assert_array_equal(out_m, out_p.numpy())
        in_gap += int((ws_m[:, 2] != 0).sum())
    want = wf.backtrack_pack_torch(p, qlt, tlt, K).numpy()
    np.testing.assert_array_equal(out_m, want)
    if kind == "gap" and tile < 64:
        assert in_gap > 0   # some walker crossed a boundary inside its gap


def test_window_walk_of_walkers_outside_their_problem():
    """Walkers handed over beyond their problem's corner (i >= tl or
    j >= ql) take the forced states, as ``tile_backtrack_torch`` does."""
    S_q, S_t, B, tile = 48, 64, 6, 112
    rng = np.random.default_rng(12)
    qs, ts, ql, tl = _pairs(rng, S_q, S_t, B, "mutated")
    ql = np.minimum(ql, 30).astype(np.int32)
    tl = np.minimum(tl, 40).astype(np.int32)
    p = torch.zeros((B, tile, S_t), dtype=torch.uint8)
    p[:, :S_q + S_t - 1] = _fill(qs, ts, 1)
    qlt, tlt = torch.from_numpy(ql), torch.from_numpy(tl)
    ws_p = torch.tensor([[tl[b] - 1 + 5 * (b % 3), ql[b] - 1 + 4 * (b % 2), 0]
                         for b in range(B)], dtype=torch.int32)
    ws_m = ws_p.numpy().copy()
    out_p = torch.zeros((B, (S_q + S_t + 2) // 4), dtype=torch.uint8)
    out_m = out_p.numpy().copy()
    wf.tile_backtrack_torch(p, qlt, tlt, ws_p, out_p, 0, S_q)
    window_walk(p.numpy(), ql, tl, ws_m, out_m, 0, S_q, 1, 32, 80)
    np.testing.assert_array_equal(ws_m, ws_p.numpy())
    np.testing.assert_array_equal(out_m, out_p.numpy())


def test_window_walk_skips_problems_outside_the_class():
    """Lengths outside the class: the rows' bytes read 'not consumed', the
    walker is left alone, nothing of ``p`` is read."""
    p = np.full((2, 24, 16), POISON, np.uint8)
    ql, tl = np.array([0, 9], np.int32), np.array([5, 17], np.int32)
    ws = np.array([[4, 0, 0], [16, 8, 0]], np.int32)
    out = np.zeros((2, 6), np.uint8)
    window_walk(p, ql, tl, ws, out, 0, 9, 1, 4, 12, 4)
    assert (out == 0xFF).all() and ws.tolist() == [[4, 0, 0], [16, 8, 0]]


@pytest.mark.parametrize("B,force,want", [
    (4, {}, (64, 144, True, 1)), (264, {}, (64, 144, True, 1)),
    (265, {}, (64, 144, True, 4)), (4096, dict(R=32), (32, 80, True, 4)),
    (4, dict(prefetch=False), (64, 80, False, 1)),
    (4, dict(R=32, prefetch=False), (32, 48, False, 1)),
    (4, dict(R=32, pw=48), (32, 48, True, 1)),
    (4, dict(R=64, pw=96, warps=8), (64, 96, True, 8)),
    (4, dict(R=0), (0, 0, False, 0)),
    (300, dict(R=32, warps=32), (32, 80, True, 32)),
])
def test_walk_plan(B, force, want):
    plan = wf.walk_plan(B, 132, **force)
    assert tuple(plan) == want
    assert plan.smem_bytes == plan.warps * 2 * plan.R * plan.pw
    assert plan.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("force", [
    dict(R=16), dict(R=48), dict(R=64, pw=72), dict(R=64, pw=64),
    dict(R=64, pw=160), dict(R=32, pw=96), dict(warps=0), dict(warps=33),
    dict(R=64, warps=16)])   # 16 walkers' patches exceed a block's memory
def test_walk_plan_rejects(force):
    with pytest.raises(ValueError):
        wf.walk_plan(4, 132, **force)
    with pytest.raises(ValueError):
        wf.walk_plan(0)


def test_walk_wrappers_take_a_plan_and_ignore_it_on_the_cpu():
    """``plan=`` is keyword-only on the three tracebacks; on CPU tensors
    they run the plain versions and count no launch."""
    rng = np.random.default_rng(8)
    qs, ts, ql, tl = _pairs(rng, 40, 48, 4, "mutated")
    qlt, tlt = torch.from_numpy(ql), torch.from_numpy(tl)
    plan = wf.walk_plan(4, R=32)
    walkers = (wf.backtrack_pack, wf.tile_backtrack,
               wf.tile_backtrack_streamed)
    n0 = [w.launches for w in walkers]
    p = _fill(qs, ts, 1)
    assert torch.equal(wf.backtrack_pack(p, qlt, tlt, plan=plan),
                       wf.backtrack_pack_torch(p, qlt, tlt))
    p2 = _fill(qs, ts, 2)
    for K, pk, walk in ((1, p, wf.tile_backtrack),
                        (2, p2, wf.tile_backtrack_streamed)):
        ws = torch.stack([tlt - 1, qlt - 1, torch.zeros_like(qlt)], 1)
        out = torch.zeros((4, (40 + 48 + 2) // 4), dtype=torch.uint8)
        tile = -(-pk.shape[1] // 4) * 4
        pt = torch.zeros((pk.shape[0], tile, 48), dtype=torch.uint8)
        pt[:, :pk.shape[1]] = pk
        args = (0, 40, K) if K > 1 else (0, 40)
        walk(pt, qlt, tlt, ws, out, *args, plan=plan)
        assert torch.equal(out, wf.backtrack_pack_torch(pk, qlt, tlt, K))
    assert [w.launches for w in walkers] == n0
    with pytest.raises(TypeError):
        wf.backtrack_pack(p, qlt, tlt, 1, plan)
