"""The two-lanes-a-word cell of the fill variants (``csrc/dp_cell2.cuh``:
``dpx2``, ``dpx2u4``, ``dpx2reg``, ``dpx2clu2``, ``dpx2clu4``) on the CPU.

A CUDA kernel cannot run here, so this file emulates the cell word for word
in plain PyTorch: two int16 lanes in each 32-bit word (held in int64
tensors as unsigned words), each intrinsic the kernels use given its
documented semantics (``__vibmax_s16x2`` with both predicates, per-half
``__vadd2``, ``__vmins2``, ``__viaddmax_s16x2_relu``, ``__byte_perm`` and
``prmt.b32`` with the sign-replicating selector), in the kernels' order.
Whole fills of the owned-lane organisation (``own_row2``) run through it
and are held byte for byte, on the band, to the reference package's NumPy
fill (``sedef_tpu.ops.wavefront.wavefront_np``, run as it is) and to the
port's plain fill.  A NumPy model of the cluster variants' schedule (a chain
of warps over C blocks, N rows apart, seam rings of 4N poisoned slots) checks
that every seam value a band lane reads is the one of the row before.
Tolerance: exact equality (integer DP, direction bytes)."""

import numpy as np
import pytest
import torch

from sedef_tpu.ops import wavefront as ref_wf
from sedef_tpu_torch.ops import wavefront as wf

torch.set_num_threads(1)

W32 = 0xFFFFFFFF
M16 = 0xFFFF


# ---------------------------------------------------------------------------
# The intrinsics, on int64 tensors holding unsigned 32-bit words
# ---------------------------------------------------------------------------

def _lo(w):
    return w & M16


def _hi(w):
    return (w >> 16) & M16


def _s16(h):
    """A 16-bit half as a signed value."""
    return (h ^ 0x8000) - 0x8000


def _join(lo, hi):
    return ((hi & M16) << 16) | (lo & M16)


def vadd2(a, b):
    """``__vadd2``: per-half add, no carry between halves."""
    return _join(_lo(a) + _lo(b), _hi(a) + _hi(b))


def vmins2(a, b):
    """``__vmins2``: per-half signed minimum."""
    return _join(torch.minimum(_s16(_lo(a)), _s16(_lo(b))),
                 torch.minimum(_s16(_hi(a)), _s16(_hi(b))))


def vibmax_s16x2(a, b):
    """``__vibmax_s16x2``: per-half signed max(a, b) and the predicates
    a >= b of the high and the low half."""
    al, ah, bl, bh = _s16(_lo(a)), _s16(_hi(a)), _s16(_lo(b)), _s16(_hi(b))
    return (_join(torch.maximum(al, bl), torch.maximum(ah, bh)), ah >= bh,
            al >= bl)


def viaddmax_s16x2_relu(a, b, c):
    """``__viaddmax_s16x2_relu``: per half max(max(a + b, c), 0), the sum
    wrapped to 16 bits."""
    def half(x, y, z):
        return torch.clamp(torch.maximum(_s16((x + y) & M16), _s16(z)),
                           min=0)
    return _join(half(_lo(a), _lo(b), _lo(c)), half(_hi(a), _hi(b), _hi(c)))


def _bytes8(x, y):
    """The eight source bytes of ``__byte_perm`` / ``prmt``: x's, then y's."""
    return [(x >> (8 * i)) & 0xFF for i in range(4)] + [
        (y >> (8 * i)) & 0xFF for i in range(4)]


def byte_perm(x, y, s: int):
    """``__byte_perm(x, y, s)``: result byte n is source byte
    (s >> 4n) & 7."""
    src = _bytes8(x, y)
    return sum(src[(s >> (4 * n)) & 7] << (8 * n) for n in range(4))


def prmt(a, b, sel):
    """``prmt.b32`` (default mode) with a selector per element: nibble n
    picks source byte nibble & 7; bit 3 of the nibble replicates that
    byte's sign over the result byte."""
    a, b, sel = torch.broadcast_tensors(a, b, sel)
    src = torch.stack(_bytes8(a, b))  # (8, ...)
    out = torch.zeros_like(a)
    for n in range(4):
        nib = (sel >> (4 * n)) & 0xF
        byte = torch.gather(src, 0, (nib & 7).unsqueeze(0)).squeeze(0)
        byte = torch.where((nib & 8) > 0,
                           torch.where((byte & 0x80) > 0, 0xFF, 0), byte)
        out |= byte << (8 * n)
    return out


def _not(w):
    return ~w & W32


def _splat(v: int) -> int:
    return (v & M16) * 0x10001


# ---------------------------------------------------------------------------
# The cell (dp_cell2.cuh), step for step
# ---------------------------------------------------------------------------

class Score2:
    def __init__(self, match, mis, gapo, gape):
        qe2 = 2 * (gapo + gape)
        self.qe2 = _splat(qe2)
        self.max_sc = _splat(match + qe2)
        self.gapo1 = _splat(gapo + 1)
        m, x = match & 0xFF, mis & 0xFF
        self.tab_lo = m | x << 8 | x << 16 | x << 24
        self.tab_hi = 0
        self.gapo = gapo


def query_code2(c):
    return torch.where((c >= 0) & (c < 4), c, 4)


def target_code2(c):
    return torch.where((c >= 0) & (c < 4), c, 8)


def left_of(prev, cur):
    return byte_perm(prev, cur, 0x5432)


def score_word(q, t, s):
    k = vmins2(q ^ t, 0x00040004 + torch.zeros_like(q))
    m = (k * 0x11 + 0x00800080) & W32
    sel = byte_perm(m, torch.zeros_like(m), 0x0020)
    tab_lo = torch.full_like(q, s.tab_lo)
    tab_hi = torch.full_like(q, s.tab_hi)
    return vadd2(prmt(tab_lo, tab_hi, sel), s.qe2)


def dp_cell2(z, xs, vs, ub, yb, s):
    """Returns (direction word, u, v, x, y)."""
    a = vadd2(xs, vs)
    b = vadd2(yb, ub)
    z, za_hi, za_lo = vibmax_s16x2(z, a)
    z, zb_hi, zb_lo = vibmax_s16x2(z, b)
    z = vmins2(z, s.max_sc + torch.zeros_like(z))
    nz2 = vadd2(_not(z), s.gapo1)
    zero = torch.zeros_like(z)
    x = viaddmax_s16x2_relu(a, nz2, zero)
    y = viaddmax_s16x2_relu(b, nz2, zero)
    z1 = vadd2(z, 0x00010001)
    u = vadd2(z1, _not(vs))
    v = vadd2(z1, _not(ub))
    fx = ((x + 0x7FFF7FFF) & W32) & 0x80008000
    fy = ((y + 0x7FFF7FFF) & W32) & 0x80008000

    def dbits(za, zb):
        return torch.where(zb, torch.where(za, 0, 1), 2)
    d = (fx >> 12) | (fy >> 11) | dbits(za_lo, zb_lo) | (
        dbits(za_hi, zb_hi) << 16)
    return d, u, v, x, y


def dir_bytes(d0, d1):
    return byte_perm(d0, d1, 0x6420)


def inject_top2(k, t0, gapo, u, y, hit):
    """(u, y) = (t ? gapo : 0, 0) at lane t0 + k, k = r - t0, where
    ``hit``; u, y: lists of the two words."""
    sh = (k & 1) * 16
    keep = _not(M16 << sh)
    val = torch.where(t0 + k > 0, gapo, 0) << sh
    for w in range(2):
        at = hit & ((k >> 1) == w)
        u[w] = torch.where(at, (u[w] & keep) | val, u[w])
        y[w] = torch.where(at, y[w] & keep, y[w])


def fill_dpx2_emulated(qseq: np.ndarray, tgt: np.ndarray, match=5, mis=-4,
                       gapo=40, gape=1) -> np.ndarray:
    """The owned-lane fill with the word cell (``fill_dpx2``): threads of
    four lanes, the state as words in two parity planes, a row's threads
    in the band updated, the others left as they are.  Returns p (B, S_q +
    S_t - 1, S_t) uint8; bytes outside the band are 0."""
    B, S_q = qseq.shape
    S_t = tgt.shape[1]
    assert S_t % 4 == 0
    G = S_t // 4
    s = Score2(match, mis, gapo, gape)
    i64 = torch.int64
    qs = query_code2(torch.from_numpy(qseq.astype(np.int64)))
    tc = target_code2(torch.from_numpy(tgt.astype(np.int64)))
    tw = [tc[:, 2 * w::4] | tc[:, 2 * w + 1::4] << 16 for w in range(2)]
    z = torch.zeros((B, G), dtype=i64)
    U, Y = [z.clone(), z.clone()], [z.clone(), z.clone()]
    X = [[z.clone(), z.clone()] for _ in range(2)]  # [parity][word]
    V = [[z.clone(), z.clone()] for _ in range(2)]
    q = [z + 4 * 0x10001, z + 4 * 0x10001]
    t0 = torch.arange(G, dtype=i64) * 4
    n_rows = S_q + S_t - 1
    p = np.zeros((B, n_rows, S_t), np.uint8)
    for r in range(n_rows):
        par = r & 1
        act = ((t0 <= r) & (t0 + 3 >= r - S_q + 1)).expand(B, G)
        Xp, Vp = X[par ^ 1], V[par ^ 1]
        # the word before the thread's: lane t0 - 1 in its high half
        xl = torch.cat([z[:, :1], Xp[1][:, :-1]], 1)
        vl = torch.cat([z[:, :1] + ((gapo if r > 0 else 0) << 16),
                        Vp[1][:, :-1]], 1)
        j = r - t0
        qn = torch.where(j < S_q, qs[:, j.clamp(0, S_q - 1)], 4)
        q1 = left_of(q[0], q[1])
        q0 = byte_perm(qn, q[0], 0x5410)
        ub, yb = [U[0], U[1]], [Y[0], Y[1]]
        inject_top2(j, t0, gapo, ub, yb, (j >= 0) & (j < 4))
        d0, u0, v0, x0, y0 = dp_cell2(score_word(q0, tw[0], s),
                                      left_of(xl, Xp[0]), left_of(vl, Vp[0]),
                                      ub[0], yb[0], s)
        d1, u1, v1, x1, y1 = dp_cell2(score_word(q1, tw[1], s),
                                      left_of(Xp[0], Xp[1]),
                                      left_of(Vp[0], Vp[1]), ub[1], yb[1], s)
        for plane, new in ((U, (u0, u1)), (Y, (y0, y1)), (X[par], (x0, x1)),
                           (V[par], (v0, v1)), (q, (q0, q1))):
            for w in range(2):
                plane[w] = torch.where(act, new[w], plane[w])
        word = torch.where(act, dir_bytes(d0, d1), 0).numpy()
        p[:, r] = word.astype("<u4").view(np.uint8).reshape(B, S_t)
    return p


# ---------------------------------------------------------------------------
# The intrinsics' semantics
# ---------------------------------------------------------------------------

def _w(*vals):
    return torch.tensor(vals, dtype=torch.int64)


def test_halves_add_and_subtract_without_carry():
    a = _w(0x0001FFFF, 0x80007FFF)
    b = _w(0x00000001, 0x80000001)
    assert vadd2(a, b).tolist() == [0x00010000, 0x00008000]
    z, vs = _w(0x00050003), _w(0x00070001)  # z - vs per half: (-2, 2)
    got = vadd2(vadd2(z, 0x00010001), _not(vs))
    assert got.tolist() == [0xFFFE0002]


def test_vibmax_gives_max_and_both_predicates():
    a = _w(_join(-3, 7))
    b = _w(_join(5, 7))
    m, p_hi, p_lo = vibmax_s16x2(a, b)
    assert m.tolist() == [_join(5, 7)]
    assert p_hi.tolist() == [True] and p_lo.tolist() == [False]


def test_relu_add_max_and_min_are_signed_per_half():
    a, b = _w(_join(-9, 20)), _w(_join(4, -25))
    assert viaddmax_s16x2_relu(a, b, _w(0)).tolist() == [0]
    assert viaddmax_s16x2_relu(a, _w(_join(10, 0)), _w(0)).tolist() == [
        _join(1, 20)]
    assert vmins2(a, b).tolist() == [_join(-9, -25)]


def test_byte_perm_takes_lane_t_minus_one():
    prev, cur = _w(0xBBBBAAAA), _w(0xDDDDCCCC)
    assert left_of(prev, cur).tolist() == [0xCCCCBBBB]
    assert byte_perm(_w(0x44332211), _w(0x88776655), 0x6420).tolist() == [
        0x77553311]


def test_prmt_replicates_the_sign_of_a_byte():
    tab = _w(0x7F80FE05)  # bytes 05, fe (-2), 80 (-128), 7f
    sel = _w(0x3B18, 0x9190)
    got = prmt(tab, _w(0), sel).tolist()
    # nibbles 8, 1, b, 3: the sign of byte 0, byte 1, the sign of byte 3,
    # byte 3; then 0, 9, 1, 9: byte 0, the sign of byte 1, byte 1, again
    assert got == [0x7F00FE00, 0xFFFEFF05]


@pytest.mark.parametrize("match,mis", [(5, -4), (127, -128), (1, -1)])
def test_score_word_is_the_cells_score(match, mis):
    s = Score2(match, mis, 40, 1)
    qe2 = 82
    codes_q = list(range(5))
    codes_t = list(range(5))
    qq, tt = np.meshgrid(codes_q, codes_t, indexing="ij")
    qq, tt = qq.ravel(), tt.ravel()
    q = query_code2(torch.from_numpy(qq))
    t = target_code2(torch.from_numpy(tt))
    # the two halves from different pairs: (q, t) low, reversed pairs high
    qw = q | q.flip(0) << 16
    tw = t | t.flip(0) << 16
    z = score_word(qw, tw, s)
    want = np.where((qq >= 4) | (tt >= 4), 0,
                    np.where(qq == tt, match, mis)) + qe2
    assert _s16(_lo(z)).tolist() == want.tolist()
    assert _s16(_hi(z)).tolist() == want[::-1].tolist()


# ---------------------------------------------------------------------------
# Whole fills against the reference
# ---------------------------------------------------------------------------

def _problems(seed, B, S_q, S_t, wild=0.0, odd=False):
    """B problems padded to the class (S_q, S_t); lengths in the class's
    upper half (odd ones with ``odd``); a share ``wild`` of wildcard codes
    on both sides; targets copied from the queries with 10% substitutions."""
    rng = np.random.default_rng(seed)
    qseq = np.full((B, S_q), 4, np.int8)
    tgt = np.full((B, S_t), 4, np.int8)
    qs, ts = [], []
    for b in range(B):
        ql = int(rng.integers(max(1, S_q // 2), S_q + 1))
        tl = int(rng.integers(max(1, S_t // 2), S_t + 1))
        if odd:
            ql -= 1 - ql % 2 if ql > 1 else 0
            tl -= 1 - tl % 2 if tl > 1 else 0
        q = rng.integers(0, 4, ql).astype(np.int8)
        n = min(ql, tl)
        t = np.concatenate([q[:n], rng.integers(0, 4, tl - n)]).astype(
            np.int8)
        mut = rng.random(tl) < 0.10
        t[mut] = rng.integers(0, 4, int(mut.sum()))
        if wild:
            q[rng.random(ql) < wild] = 4
            t[rng.random(tl) < wild] = 4
        qseq[b, :ql], tgt[b, :tl] = q, t
        qs.append(q)
        ts.append(t)
    return qseq, tgt, qs, ts


def _triangle(ql, tl, n_rows, S_t):
    r = np.arange(n_rows)[:, None]
    t = np.arange(S_t)[None, :]
    return (t <= r) & (r - t < ql) & (t < tl)


CASES = {
    # unequal class lengths, both ways
    "unequal": dict(seed=1, B=4, S_q=96, S_t=64),
    "unequal_t": dict(seed=2, B=3, S_q=40, S_t=128),
    # wildcards on both sides
    "wildcards": dict(seed=3, B=4, S_q=64, S_t=64, wild=0.15),
    # odd lengths and an odd query class: band edges at odd lanes, where a
    # word holds one lane in the band and one outside
    "odd_edges": dict(seed=4, B=8, S_q=77, S_t=60, odd=True),
    "odd_edges_wild": dict(seed=5, B=5, S_q=33, S_t=100, odd=True,
                           wild=0.1),
}
# the default scoring, the wrapper's int16 limit (match + 2 (gapo + gape)
# + gapo = 32767, the int8 table's extremes) and a narrow gap scoring
SCORINGS = {"default": (5, -4, 40, 1), "limit": (127, -128, 10000, 1320),
            "narrow": (2, -3, 5, 2)}


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_word_fill_equals_references(case, scoring):
    """The word-level fill equals wavefront_np on every problem's triangle
    and the port's plain fill on the class band, byte for byte."""
    match, mis, gapo, gape = SCORINGS[scoring]
    assert wf.dpx2_scoring_fits(match, mis, gapo, gape)
    kw = CASES[case]
    qseq, tgt, qs, ts = _problems(**kw)
    S_q, S_t = qseq.shape[1], tgt.shape[1]
    p = fill_dpx2_emulated(qseq, tgt, match, mis, gapo, gape)
    n_rows = S_q + S_t - 1
    for b, (qi, ti) in enumerate(zip(qs, ts)):
        p_ref, _ = ref_wf.wavefront_np(qi, ti, match, mis, gapo, gape)
        m = _triangle(len(qi), len(ti), n_rows, S_t)
        np.testing.assert_array_equal(p[b][m], p_ref[m[:p_ref.shape[0],
                                                       :p_ref.shape[1]]],
                                      err_msg=f"problem {b}")
    plain = wf.wavefront_fill_torch(torch.from_numpy(qseq),
                                    torch.from_numpy(tgt), match, mis, gapo,
                                    gape).numpy()
    band = wf.stream_band(0, n_rows, S_q, S_t, 1, "cpu").numpy()
    for b in range(qseq.shape[0]):
        np.testing.assert_array_equal(p[b][band], plain[b][band])


def test_emulated_fill_matches_golden_problem_cigars():
    """The reference harness's golden problem: CIGARs of the word fill
    equal the NumPy reference's."""
    from sedef_tpu_torch.tools import kbench
    qseq, tgt, qs, ts = kbench.golden_problem()
    p = fill_dpx2_emulated(qseq, tgt)
    for i, (qi, ti) in enumerate(zip(qs, ts)):
        p_ref, _ = ref_wf.wavefront_np(qi, ti)
        assert (ref_wf.backtrack_np(p[i], len(qi), len(ti))
                == ref_wf.backtrack_np(p_ref, len(qi), len(ti))), i


def test_band_edge_words_hold_one_lane_in_and_one_out():
    """The odd-edge cases really put a band edge inside a word: rows whose
    first band lane is odd (the low half out of the band, the high half
    in)."""
    qseq, tgt, _, _ = _problems(**CASES["odd_edges"])
    S_q, S_t = qseq.shape[1], tgt.shape[1]
    band = wf.stream_band(0, S_q + S_t - 1, S_q, S_t, 1, "cpu").numpy()
    first = band.argmax(1)
    assert (first % 2 == 1).sum() > 10
    last = S_t - 1 - band[:, ::-1].argmax(1)
    assert (last % 2 == 0).sum() > 10


# ---------------------------------------------------------------------------
# The wrapper's limits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,S_t", [("clu2", 136), ("clu4", 144),
                                         ("dpx2clu2", 200), ("dpx2", 130),
                                         ("dpx2reg", 66)])
def test_width_that_is_no_multiple_raises(variant, S_t):
    q = torch.zeros((2, 64), dtype=torch.int8)
    t = torch.zeros((2, S_t), dtype=torch.int8)
    with pytest.raises(ValueError):
        wf.wavefront_fill_variant(variant, q, t)


@pytest.mark.parametrize("variant,S_t", [("clu2", 8192 + 16),
                                         ("clu4", 16384 + 32),
                                         ("dpx2clu4", 16384 + 32),
                                         ("dpx2u4", 4100)])
def test_width_over_the_block_limit_raises(variant, S_t):
    q = torch.zeros((1, 8), dtype=torch.int8)
    t = torch.zeros((1, S_t), dtype=torch.int8)
    with pytest.raises(ValueError):
        wf.wavefront_fill_variant(variant, q, t)


@pytest.mark.parametrize("variant,S_t", [("clu2", 8192), ("clu4", 16384),
                                         ("dpx2clu4", 16384), ("dpx2", 4096),
                                         ("clu4", 32)])
def test_widest_and_narrowest_cluster_classes_are_taken(variant, S_t):
    wf.check_variant_shape(variant, S_t, 5, -4, 40, 1)


@pytest.mark.parametrize("scoring", [(5, -4, 10950, 1),     # 32857
                                     (128, -4, 40, 1),      # table: int8
                                     (5, -129, 40, 1)])
def test_scoring_over_the_limit_raises(scoring):
    match, mis, gapo, gape = scoring
    assert not wf.dpx2_scoring_fits(match, mis, gapo, gape)
    q = torch.zeros((2, 64), dtype=torch.int8)
    for variant in ("dpx2", "dpx2u4", "dpx2reg", "dpx2clu2", "dpx2clu4"):
        with pytest.raises(ValueError):
            wf.wavefront_fill_variant(variant, q, q, match, mis, gapo, gape)
    # the scalar variants take it
    assert wf.wavefront_fill_variant("unroll4", q, q, match, mis, gapo,
                                     gape).shape == (2, 127, 64)


def test_scoring_at_the_limit_is_taken():
    match, mis, gapo, gape = SCORINGS["limit"]
    assert match + 2 * (gapo + gape) + gapo == wf.DPX2_LIMIT - 1
    assert not wf.dpx2_scoring_fits(match, mis, gapo, gape + 1)
    q = torch.zeros((2, 64), dtype=torch.int8)
    assert wf.wavefront_fill_variant("dpx2", q, q, match, mis, gapo,
                                     gape).shape == (2, 127, 64)


def test_new_variants_are_listed():
    for v in ("dpx2", "dpx2u4", "dpx2reg", "clu2", "clu4", "dpx2clu2",
              "dpx2clu4"):
        assert v in wf.FILL_VARIANTS
    assert wf.VARIANT_CLUSTER == {"clu2": 2, "clu4": 4, "dpx2clu2": 2,
                                  "dpx2clu4": 4}
    with pytest.raises(ValueError):
        wf.fill_variant_clusters("unroll4", 128, 128, torch.device("cpu"))


# ---------------------------------------------------------------------------
# The cluster variants' schedule (fill_chain), as a model
# ---------------------------------------------------------------------------

def _chain_lanes(variant: str, S_t: int) -> int:
    """Lanes a thread (``chain_lanes`` of the kernel source)."""
    C = wf.VARIANT_CLUSTER.get(variant, 1)
    return 2 if variant.startswith("dpx2") and C > 1 and S_t // C <= 2048 \
        else 4


def _run_chain_schedule(S_q, S_t, C, N, lanes, ring_rows=4):
    """Steps of ``fill_chain``: warp g = c * warps + w fills rows (st - g)
    * N .. + N - 1 of the rows whose band meets its lanes; the sender of
    each seam (lane 31 of a block's inner warps, the thread of a block's
    last lane towards block c + 1) writes slot r % 4N of the next warp's
    ring after its row r; the next warp's lane 0 reads slot (r - 1) % 4N
    for row r.  Writes become visible at the step's barrier.  Returns the
    band reads that found another row than r - 1, or a slot written in
    the same step (a race).  ``ring_rows``: slots a ring, in units of N."""
    RING = ring_rows * N
    Wl = S_t // C
    threads = -(-(Wl // lanes) // 32) * 32
    Wb = threads // 32
    n_warps = C * Wb
    n_rows = S_q + S_t - 1
    # ring i is read by chain warp i (its set 0 for a block's warp 0)
    rings = np.full((n_warps, RING), -7, np.int64)  # poisoned
    first_lane = [c * Wl + w * 32 * lanes for c in range(C)
                  for w in range(Wb)]
    bad = 0
    n_steps = -(-n_rows // N) + n_warps - 1
    for st in range(n_steps):
        writes = []
        reads = []
        for g in range(n_warps):
            wl = first_lane[g]
            for i in range(N):
                r = (st - g) * N + i
                if not (0 <= r < n_rows and wl <= r
                        and wl + 32 * lanes - 1 >= r - S_q + 1):
                    continue
                # lane 0 of the warp reads the seam of row r - 1, if its
                # first lane is in the band and has a left neighbour
                if g > 0 and 0 <= r - wl < S_q and wl < S_t:
                    reads.append((g, (r - 1) % RING, r - 1))
                if g + 1 < n_warps:
                    writes.append((g + 1, r % RING, r))
        written = {(ring, slot) for ring, slot, _ in writes}
        for ring, slot, want in reads:
            if rings[ring, slot] != want or (ring, slot) in written:
                bad += 1
        for ring, slot, row in writes:
            rings[ring, slot] = row
    return bad


def _chain_cases():
    """(variant, S_q, S_t) of the schedule model: every class of the list
    the variant takes."""
    out = []
    for variant in ("clu2", "clu4", "dpx2clu2", "dpx2clu4", "dpx2reg"):
        C = wf.VARIANT_CLUSTER.get(variant, 1)
        for S_q, S_t in ((1024, 1024), (100, 1024), (2048, 512), (64, 4096),
                         (128, 128), (300, 2048)):
            if S_t % (8 * C if C > 1 else 4) == 0 and S_t <= 4096 * C:
                out.append((variant, S_q, S_t))
    return out


@pytest.mark.parametrize("variant,S_q,S_t", _chain_cases())
def test_chain_schedule_reads_every_seam_of_the_row_before(variant, S_q,
                                                           S_t):
    C = wf.VARIANT_CLUSTER.get(variant, 1)
    N = 4 if variant == "dpx2reg" else 32
    assert _run_chain_schedule(S_q, S_t, C, N,
                               _chain_lanes(variant, S_t)) == 0


def test_chain_schedule_needs_more_than_2n_slots():
    """The model does find a reused slot: with rings of 2N slots (one too
    few for the 2N + 1 live rows) reads go wrong."""
    assert _run_chain_schedule(512, 1024, 2, 8, 4, ring_rows=2) > 0
