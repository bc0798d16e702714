"""The port's gap-DP kernels (plain PyTorch versions, as they run on the
CPU) against the reference package: ``wavefront_np`` / ``backtrack_np``,
the Pallas kernels in interpret mode, and ksw2's own CIGARs.  Tolerance:
exact equality everywhere (integer DP, byte-for-byte ops and CIGARs)."""

import numpy as np
import pytest
import torch

from sedef_tpu.ops import wavefront as ref_wf
from sedef_tpu_torch.ops import wavefront as wf

from test_wavefront import _cigar_str, _load_pairs

torch.set_num_threads(1)


def _random_batch(rng, S_q, S_t, B, wild=0.05, edges=True):
    """B random problems padded into one (S_q, S_t) class; ql != tl, some
    wildcard codes, and length-1 edges when ``edges``."""
    qs = np.full((B, S_q), 4, np.int8)
    ts = np.full((B, S_t), 4, np.int8)
    ql = rng.integers(max(1, S_q // 2), S_q + 1, B).astype(np.int32)
    tl = rng.integers(max(1, S_t // 2), S_t + 1, B).astype(np.int32)
    if edges and B >= 3:
        ql[0] = 1
        tl[1] = 1
        ql[2] = tl[2] = 1
    probs = []
    for b in range(B):
        q = rng.integers(0, 4, ql[b]).astype(np.int8)
        # targets share the query's prefix so alignments are non-trivial
        n = min(ql[b], tl[b])
        t = np.concatenate([q[:n], rng.integers(0, 4, tl[b] - n)]
                           ).astype(np.int8)
        mut = rng.random(tl[b]) < 0.1
        t[mut] = rng.integers(0, 4, int(mut.sum()))
        q[rng.random(ql[b]) < wild] = 4
        t[rng.random(tl[b]) < wild] = 4
        qs[b, :ql[b]] = q
        ts[b, :tl[b]] = t
        probs.append((q, t))
    return qs, ts, ql, tl, probs


@pytest.mark.parametrize("S_q,S_t", [(128, 128), (256, 128), (128, 512),
                                     (512, 256), (1024, 1024), (2048, 512)])
def test_fill_matches_numpy_on_triangle(S_q, S_t):
    rng = np.random.default_rng(S_q * 7 + S_t)
    qs, ts, ql, tl, probs = _random_batch(rng, S_q, S_t, 4)
    p = wf.wavefront_fill(torch.from_numpy(qs), torch.from_numpy(ts)).numpy()
    assert p.shape == (4, S_q + S_t - 1, S_t) and p.dtype == np.uint8
    for b, (q, t) in enumerate(probs):
        p_ref, _ = ref_wf.wavefront_np(q, t)
        for r in range(len(q) + len(t) - 1):
            st0, en0 = max(0, r - len(q) + 1), min(r, len(t) - 1)
            np.testing.assert_array_equal(p[b, r, st0:en0 + 1],
                                          p_ref[r, st0:en0 + 1],
                                          err_msg=f"problem {b} row {r}")


@pytest.mark.parametrize("S_q,S_t", [(128, 128), (256, 512), (1024, 256)])
def test_traceback_cigars_match_backtrack_np(S_q, S_t):
    rng = np.random.default_rng(100 + S_q + S_t)
    qs, ts, ql, tl, probs = _random_batch(rng, S_q, S_t, 6)
    p = wf.wavefront_fill(torch.from_numpy(qs), torch.from_numpy(ts))
    packed = wf.backtrack_pack(p, torch.from_numpy(ql),
                               torch.from_numpy(tl)).numpy()
    assert packed.shape == (6, (S_q + S_t - 1 + 3) // 4)
    for b, (q, t) in enumerate(probs):
        p_ref, _ = ref_wf.wavefront_np(q, t)
        assert (wf.cigar_from_packed_ops(packed[b], len(q), len(t))
                == ref_wf.backtrack_np(p_ref, len(q), len(t))), b


def _pack_codes(codes):
    """(B, 4n) 2-bit codes -> (B, n) bytes, low bits first."""
    c = codes.astype(np.uint8)
    return c[:, 0::4] | c[:, 1::4] << 2 | c[:, 2::4] << 4 | c[:, 3::4] << 6


def _stream_row(rng, ql, tl, d_res, i_res, first=None):
    """One problem's codes over its ql + tl - 1 anti-diagonals: moves that
    leave d_res D and i_res I on the edge (negative: that many too many),
    first move ``first`` when given, the other rows 3."""
    n_m = max(min(ql - max(d_res, 0), tl - max(i_res, 0)) // 2, 0)
    n_d = max(ql - d_res - n_m, 0)
    n_i = max(tl - i_res - n_m, 0)
    moves = rng.permutation(np.repeat([0, 1, 2], [n_m, n_i, n_d]))
    if first is not None:
        moves = np.concatenate([[first], moves])
    n_diag = ql + tl - 1
    moves = moves[:n_diag]
    row = np.full(n_diag, 3, np.uint8)
    row[np.sort(rng.choice(n_diag, len(moves), replace=False))] = moves
    return row


def _decode_case(kind, S, B, rng):
    """(packed ops, ql, tl) of B problems in the (S, S) class: rows of
    ``kind``, codes 0-3 (mostly not 3) past every row's n_diag."""
    width = 4 * ((2 * S - 1 + 3) // 4)
    codes = rng.integers(0, 3, (B, width)).astype(np.uint8)
    ql = rng.integers(1, S + 1, B)
    tl = rng.integers(1, S + 1, B)
    if kind == "len1":
        ql[::2] = 1
        tl[1::2] = 1
        tl[::3] = 1
    for b in range(B):
        n_diag = ql[b] + tl[b] - 1
        if kind == "random":
            codes[b, :n_diag] = rng.integers(0, 4, n_diag)
        elif kind == "all3":
            codes[b, :n_diag] = 3
        elif kind in ("residuals", "len1"):
            d, i = rng.integers(-2, 3, 2) * rng.integers(0, 4, 2)
            codes[b, :n_diag] = _stream_row(rng, int(ql[b]), int(tl[b]),
                                            int(d), int(i))
        elif kind == "merge":
            # an I residual ahead of a first I, or a D residual alone ahead
            # of a first D
            i_res = int(rng.integers(0, 2) * rng.integers(1, 4))
            codes[b, :n_diag] = _stream_row(rng, int(ql[b]), int(tl[b]),
                                            int(rng.integers(0, 4)), i_res,
                                            first=1 if i_res else 2)
    return _pack_codes(codes), ql, tl


@pytest.mark.parametrize("kind,S,B", [
    (kind, S, B) for kind in ("random", "residuals", "merge", "all3", "len1")
    for S, B in ((128, 300), (256, 1), (512, 300), (1024, 1), (2048, 24))]
    + [("walker", 128, 300), ("walker", 256, 1)])
def test_group_decode_matches_reference_decode(kind, S, B):
    """``cigars_from_packed`` over a whole group gives, tuple for tuple,
    the reference package's one-row ``cigar_from_packed_ops`` of every
    row (``walker``: ``backtrack_pack``'s output on the CPU tensor path,
    also ``backtrack_np``'s CIGARs)."""
    rng = np.random.default_rng(S * 10 + B + len(kind))
    if kind == "walker":
        qs, ts, ql, tl, probs = _random_batch(rng, S, S, B)
        packed = wf.backtrack_pack(
            wf.wavefront_fill(torch.from_numpy(qs), torch.from_numpy(ts)),
            torch.from_numpy(ql), torch.from_numpy(tl)).numpy()
    else:
        packed, ql, tl = _decode_case(kind, S, B, rng)
    got = wf.cigars_from_packed(packed, ql, tl)
    assert len(got) == B
    for b in range(B):
        want = ref_wf.cigar_from_packed_ops(packed[b], int(ql[b]), int(tl[b]))
        assert got[b] == want, b
        assert wf.cigar_from_packed_ops(packed[b], int(ql[b]),
                                        int(tl[b])) == want, b
        if kind == "walker":
            q, t = probs[b]
            assert want == ref_wf.backtrack_np(ref_wf.wavefront_np(q, t)[0],
                                               len(q), len(t)), b


def test_packed_ops_match_pallas_interpret():
    """Byte-identical packed ops against the reference package's fused
    Pallas fill + traceback, run in interpret mode as its own tests do."""
    rng = np.random.default_rng(11)
    qs, ts, ql, tl, _ = _random_batch(rng, 128, 128, 8, edges=True)
    got = wf.backtrack_pack(
        wf.wavefront_fill(torch.from_numpy(qs), torch.from_numpy(ts)),
        torch.from_numpy(ql), torch.from_numpy(tl)).numpy()
    want = np.asarray(ref_wf.wavefront_cigar_device(
        qs, ts, ql, tl, 128, 128, interpret=True, G=1, SUB=8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["ksw2_pairs_1", "ksw2_pairs_2"])
def test_plain_path_matches_ksw2(fixtures_dir, name, monkeypatch):
    """Every pair through the aligner's device route on the CPU (the
    plain fill + traceback, grouped per size class) gives ksw2's CIGAR."""
    monkeypatch.setattr(wf.WavefrontAligner, "DEVICE_BATCH_MIN", 1)
    monkeypatch.setattr(wf.WavefrontAligner, "DEVICE_BATCH_MIN_CELLS", 0)
    pairs = _load_pairs(fixtures_dir / f"{name}.txt")
    al = wf.WavefrontAligner(device="cpu")
    got = al.align_batch([(q, t) for q, t, _, _ in pairs])
    assert al.device_problems == len(pairs)
    for (q, t, _, cigar_ref), cig in zip(pairs, got):
        assert _cigar_str(cig) == cigar_ref


def test_aligner_routes_stragglers_native_and_bulk_to_device():
    """Below the bulk thresholds the native scalar DP answers; the CIGARs
    equal the device route's, and degenerate problems get D/I runs."""
    rng = np.random.default_rng(5)
    pairs = [(rng.integers(0, 4, n).astype(np.int8),
              rng.integers(0, 4, m).astype(np.int8))
             for n, m in [(40, 50), (90, 70), (130, 128)]]
    pairs.append((np.zeros(0, np.int8), np.zeros(3, np.int8)))
    al = wf.WavefrontAligner(device="cpu")
    native = al.align_batch(pairs)
    assert al.device_problems == 0
    assert native[-1] == [("I", 3)]
    al.DEVICE_BATCH_MIN = 1
    al.DEVICE_BATCH_MIN_CELLS = 0
    assert al.align_batch(pairs) == native
    assert al.device_problems == 3


def test_cpu_tensors_take_plain_version_without_launching():
    rng = np.random.default_rng(2)
    qs, ts, ql, tl, _ = _random_batch(rng, 128, 256, 3)
    before = (wf.wavefront_fill.launches, wf.backtrack_pack.launches)
    p = wf.wavefront_fill(torch.from_numpy(qs), torch.from_numpy(ts))
    torch.testing.assert_close(p, wf.wavefront_fill_torch(
        torch.from_numpy(qs), torch.from_numpy(ts)), rtol=0, atol=0)
    wf.backtrack_pack(p, torch.from_numpy(ql), torch.from_numpy(tl))
    assert (wf.wavefront_fill.launches, wf.backtrack_pack.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "ndim", "contiguous", "batch"])
def test_wrappers_reject_malformed_inputs(bad):
    q = torch.zeros((2, 128), dtype=torch.int8)
    t = torch.zeros((2, 128), dtype=torch.int8)
    if bad == "dtype":
        q = q.to(torch.int32)
    elif bad == "ndim":
        q = q[0]
    elif bad == "contiguous":
        q = torch.zeros((128, 2), dtype=torch.int8).t()
    else:
        t = t[:1]
    with pytest.raises(ValueError):
        wf.wavefront_fill(q, t)


def test_cuda_aligner_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf.WavefrontAligner(device="cuda")
    with pytest.raises(ValueError):
        wf.WavefrontAligner(device="meta")


def test_chunked_strings_one_batch():
    """align_strings chunks at max_ksw_seq_len and concatenates."""
    from sedef_tpu_torch.config import Config
    cfg = Config().finalize()
    cfg.align.max_ksw_seq_len = 64
    al = wf.WavefrontAligner(cfg=cfg, device="cpu")
    al.DEVICE_BATCH_MIN = 1
    al.DEVICE_BATCH_MIN_CELLS = 0
    rng = np.random.default_rng(1)
    s = "".join(rng.choice(list("ACGT"), 150))
    assert al.align_strings(s, s) == [("M", 150)]
    assert al.device_problems == 3
