"""The port's streamed and tiled gap-DP routes (plain PyTorch versions, as
they run on the CPU) against the reference package: its streamed, tiled
and streamed-tiled Pallas kernels in interpret mode, and
``wavefront_np`` / ``backtrack_np``.  Tolerance: exact equality (integer
DP, byte-for-byte ops and CIGARs)."""

import numpy as np
import pytest
import torch

from sedef_tpu.ops import wavefront as ref_wf
from sedef_tpu_torch.ops import wavefront as wf

torch.set_num_threads(1)


def _batch(rng, S_q, S_t, B, lo=0.55):
    """B problems of one class, lengths in [lo * S, S], targets sharing
    the query with 12% substitutions, a few wildcards."""
    qs = np.full((B, S_q), 4, np.int8)
    ts = np.full((B, S_t), 4, np.int8)
    ql = rng.integers(int(lo * S_q), S_q + 1, B).astype(np.int32)
    tl = rng.integers(int(lo * S_t), S_t + 1, B).astype(np.int32)
    probs = []
    for b in range(B):
        t = rng.integers(0, 4, max(ql[b], tl[b])).astype(np.int8)
        q = t.copy()
        m = rng.random(len(q)) < 0.12
        q[m] = (q[m] + rng.integers(1, 4, int(m.sum()))) % 4
        q, t = q[:ql[b]], t[:tl[b]]
        q[rng.random(len(q)) < 0.02] = 4
        qs[b, :ql[b]] = q
        ts[b, :tl[b]] = t
        probs.append((q, t))
    return qs, ts, ql, tl, probs


def _tiled_ops(qs, ts, ql, tl, K, tile):
    """Packed ops of the port's tiled route (streamed when K > 1), driven
    tile by tile as the aligner drives it."""
    q, t = torch.from_numpy(qs), torch.from_numpy(ts)
    qlt, tlt = torch.from_numpy(ql), torch.from_numpy(tl)
    return wf.WavefrontAligner._solve_tiled(q, t, qlt, tlt, K, tile,
                                            (5, -4, 40, 1)).numpy()


def _pack_ref(ops):
    """The reference's unpacked ops (255 = not consumed) in the port's
    2-bit packing."""
    o = np.minimum(ops, 3).astype(np.uint8)
    o = np.concatenate([o, np.full((len(o), -o.shape[1] % 4), 3, np.uint8)],
                       axis=1)
    return o[:, 0::4] | (o[:, 1::4] << 2) | (o[:, 2::4] << 4) | (o[:, 3::4]
                                                                << 6)


def _assert_prefix(got, want):
    """Equal bytes over the port's ceil(n_diag / 4); the reference's row
    padding past n_diag is all 'not consumed'."""
    nb = got.shape[1]
    np.testing.assert_array_equal(got, want[:, :nb])
    assert (want[:, nb:] == 0xFF).all()


@pytest.mark.parametrize("S_q,S_t,K", [(128, 128, 2), (128, 256, 2),
                                       (256, 128, 2), (128, 128, 3)])
def test_streamed_ops_match_pallas_interpret(S_q, S_t, K):
    """Streamed fill + traceback: byte-identical packed ops against the
    reference package's streamed Pallas kernel (8 streams of K; classes
    with S_q < S_t, S_q = S_t and S_q > S_t, and streams of 3)."""
    rng = np.random.default_rng(S_q + S_t + K)
    qs, ts, ql, tl, _ = _batch(rng, S_q, S_t, 8 * K)
    p = wf.wavefront_fill_streamed(torch.from_numpy(qs), torch.from_numpy(ts),
                                   K)
    assert p.shape == (8, K * S_q + S_t - 1, S_t)
    got = wf.backtrack_pack(p, torch.from_numpy(ql), torch.from_numpy(tl),
                            K).numpy()
    want = np.asarray(ref_wf.wavefront_cigar_pipelined(
        qs, ts, ql, tl, S_q, S_t, K, SUB=8, interpret=True))
    _assert_prefix(got, want)


def test_streamed_rows_match_numpy_on_triangle():
    """Problem k's direction rows of a stream, stream rows [k * S_q, ...),
    equal ``wavefront_np``'s on its triangle."""
    rng = np.random.default_rng(31)
    S_q, S_t, K = 128, 384, 3
    qs, ts, _, _, probs = _batch(rng, S_q, S_t, 2 * K, lo=0.3)
    p = wf.wavefront_fill_streamed(torch.from_numpy(qs), torch.from_numpy(ts),
                                   K).numpy()
    for b, (q, t) in enumerate(probs):
        s, k = divmod(b, K)
        p_ref, _ = ref_wf.wavefront_np(q, t)
        for r in range(len(q) + len(t) - 1):
            st0, en0 = max(0, r - len(q) + 1), min(r, len(t) - 1)
            np.testing.assert_array_equal(
                p[s, k * S_q + r, st0:en0 + 1], p_ref[r, st0:en0 + 1],
                err_msg=f"problem {b} row {r}")


def test_tiled_ops_match_pallas_interpret():
    """Checkpoint / refill / tile traceback over several tiles:
    byte-identical to the reference package's tiled Pallas route."""
    rng = np.random.default_rng(5)
    S, B, tile = 256, 8, 128
    qs, ts, ql, tl, _ = _batch(rng, S, S, B)
    got = _tiled_ops(qs, ts, ql, tl, 1, tile)
    want = np.asarray(ref_wf.wavefront_cigar_tiled(
        qs, ts, ql, tl, S, S, TILE=tile, interpret=True))
    _assert_prefix(got, _pack_ref(want))


def test_tiled_streamed_ops_match_pallas_interpret():
    """The streamed tiled route: byte-identical to the reference package's
    streamed-tiled Pallas route (8 streams of K, tiles spanning problems)."""
    rng = np.random.default_rng(13)
    S, K, tile = 128, 2, 128
    qs, ts, ql, tl, _ = _batch(rng, S, S, 8 * K)
    got = _tiled_ops(qs, ts, ql, tl, K, tile)
    want = np.asarray(ref_wf.wavefront_cigar_tiled_pipelined(
        qs, ts, ql, tl, S, S, K, SUB=8, TILE=tile, interpret=True))
    _assert_prefix(got, _pack_ref(want))


@pytest.mark.parametrize("S_q,S_t,K,tile", [(128, 128, 1, 64),
                                            (128, 512, 3, 128),
                                            (512, 128, 2, 64)])
def test_tiled_ops_equal_direct_route(S_q, S_t, K, tile):
    """Any tiling, streamed or not, gives the direct route's packed ops,
    and refilled tiles equal the direct rows on every written lane."""
    rng = np.random.default_rng(S_q * 5 + S_t + K)
    qs, ts, ql, tl, _ = _batch(rng, S_q, S_t, 2 * K, lo=0.2)
    q, t = torch.from_numpy(qs), torch.from_numpy(ts)
    direct = wf.backtrack_pack(wf.wavefront_fill(q, t), torch.from_numpy(ql),
                               torch.from_numpy(tl)).numpy()
    np.testing.assert_array_equal(_tiled_ops(qs, ts, ql, tl, K, tile),
                                  direct)
    p = wf.wavefront_fill_streamed(q, t, K)
    ckpt = wf.tile_checkpoint_streamed(q, t, K, tile)
    n_rows = p.shape[1]
    for ti in range(ckpt.shape[1]):
        pt = wf.tile_refill_streamed(q, t, ckpt, ti, K, tile)
        rows = min(tile, n_rows - ti * tile)
        m = wf.stream_band(ti * tile, ti * tile + rows, S_q, S_t, K)
        for s in range(p.shape[0]):
            assert torch.equal(pt[s, :rows][m],
                               p[s, ti * tile:ti * tile + rows][m]), (ti, s)


def _route_pairs(rng, spec):
    pairs = []
    for lo, hi, cnt in spec:
        for _ in range(cnt):
            n = int(rng.integers(lo, hi + 1))
            t = rng.integers(0, 4, n).astype(np.int8)
            q = t.copy()
            m = rng.random(n) < 0.1
            q[m] = rng.integers(0, 4, int(m.sum()))
            pairs.append((q, t[:n - int(rng.integers(0, 20))]))
    return pairs


def test_aligner_routes_each_class(monkeypatch):
    """With lowered class thresholds one batch takes the direct, streamed
    and streamed-tiled routes (and a small giant class the tiled one);
    every CIGAR equals the NumPy reference's."""
    rng = np.random.default_rng(4)
    al = wf.WavefrontAligner(device="cpu")
    al.DEVICE_BATCH_MIN = 1
    al.DEVICE_BATCH_MIN_CELLS = 0
    al.GIANT_S_T = 256
    al.STREAM_MIN_S_T = 256
    al.STREAM_MIN_PROBLEMS = 4
    al.GIANT_STREAMS = 2
    calls = []
    solve = al._solve

    def spy(pairs, part, S_q, S_t, K, tile):
        calls.append((S_q, S_t, len(part), K, tile))
        return solve(pairs, part, S_q, S_t, K, tile)

    monkeypatch.setattr(al, "_solve", spy)
    pairs = _route_pairs(rng, [(40, 128, 3), (150, 256, 9), (300, 512, 5)])
    got = al.align_batch(pairs)
    for (q, t), cig in zip(pairs, got):
        p, _ = ref_wf.wavefront_np(q, t)
        assert cig == ref_wf.backtrack_np(p, len(q), len(t))
    assert sorted(calls) == [(128, 128, 3, 1, None), (256, 256, 9, 2, None),
                             (512, 512, 5, 3, 1024)]
    calls.clear()
    al.GIANT_STREAMS = 8
    assert al.align_batch(pairs[-5:]) == got[-5:]
    assert calls == [(512, 512, 5, 1, 1024)]


def test_route_thresholds_mirror_the_reference():
    """The class rules are the reference package's: giant beyond S_t 8192
    or a 2^30-byte sublane group, streamed from S_t 1024 above 32
    problems (its sublane count there), streamed giants above 8."""
    A = wf.WavefrontAligner
    R = ref_wf.WavefrontAligner
    assert A.GIANT_S_T == R.GIANT_S_T
    assert A.GIANT_P_BYTES * 8 == 1 << 30
    assert A.GIANT_K_LADDER == R.GIANT_K_LADDER
    for S_t in (1024, 2048, 4096, 8192):
        assert ref_wf._lane_groups(S_t) == 1
        assert ref_wf._sublane_pack(S_t) == A.STREAM_MIN_PROBLEMS
    assert ref_wf._lane_groups(A.STREAM_MIN_S_T // 2) > 1
