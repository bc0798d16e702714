"""The region path's anchors as arrays (``sedef_tpu_torch/ops/anchors.py``,
``ops/chain.py``, ``ops/cigar.py``'s ``Alignment.from_anchors_many``) held
against the reference package's list forms on the same inputs: the anchor
rows of the native scan and of the NumPy fallback, the chains of the native
DP and of the Python one, and the chains' alignments on random chains whose
gaps take every branch of the gap policy (none, one-sided, a DP, a DP plus
an indel, the zero-length indel of equal big sides) under the port's host
aligner and under a scripted one whose CIGARs end in either indel.
Tolerance: exact equality (rows, paths, bounds, CIGARs with their
zero-length ops, strings and tallies)."""

import random
import zlib

import numpy as np
import pytest
import torch

from sedef_tpu.ops import anchors as ref_anchors
from sedef_tpu.ops import chain as ref_chain
from sedef_tpu.ops.cigar import Alignment as RefAlignment
from sedef_tpu.ops.cigar import _batch_gap_cigars as ref_batch_gap_cigars
from sedef_tpu_torch.models import simulate as sim
from sedef_tpu_torch.native import lib as native
from sedef_tpu_torch.ops import anchors, chain
from sedef_tpu_torch.ops.cigar import Alignment, _batch_gap_cigars
from sedef_tpu_torch.ops.wavefront import WavefrontAligner

torch.set_num_threads(1)

# every gap DP on the native host DP: none reaches the plain torch fill
AL = WavefrontAligner(device="cpu")
AL.DEVICE_BATCH_MIN = 1 << 30


class ScriptedAligner:
    """A stand-in for the aligner: for each problem a valid CIGAR drawn
    from the problem's lengths and bases, so that both packages get the
    same one.  It may start or end in any op, and ends in ``tail`` where
    that is given."""

    def __init__(self, tail: str | None = None):
        self.tail = tail

    def align_batch(self, pairs):
        return [self._one(np.asarray(qc), np.asarray(tc)) for qc, tc in pairs]

    def _one(self, qc, tc):
        rng = random.Random(zlib.crc32(qc.tobytes() + b"|" + tc.tobytes()))
        nq, nt = len(qc), len(tc)
        tail = []
        if self.tail == "I" and nt:
            tail, nt = [("I", 1)], nt - 1
        elif self.tail == "D" and nq:
            tail, nq = [("D", 1)], nq - 1
        out = []
        while nq or nt:
            op = rng.choice("MMMDI")
            if op == "M" and nq and nt:
                ln = rng.randint(1, min(nq, nt, 40))
                nq -= ln
                nt -= ln
            elif op == "D" and nq:
                ln = rng.randint(1, min(nq, 6))
                nq -= ln
            elif op == "I" and nt:
                ln = rng.randint(1, min(nt, 6))
                nt -= ln
            else:
                continue
            out.append((op, ln))
        return out + tail


def _chains(rng: random.Random, qlen: int, rlen: int, n_chains: int):
    """Random chains of (q, r, len) anchors on strings of the given
    lengths, each gap one of the policy's kinds."""
    kinds = ["none", "q", "r", "small", "small", "bigq", "bigr", "equal"]
    out = []
    for _ in range(n_chains):
        q, r = rng.randint(0, 400), rng.randint(0, 400)
        ln = rng.randint(11, 60)
        chain_ = [(q, r, ln)]
        for _ in range(rng.randint(0, 14)):
            kind = rng.choice(kinds)
            qg, rg = {"none": (0, 0),
                      "q": (rng.randint(1, 1500), 0),
                      "r": (0, rng.randint(1, 1500)),
                      "small": (rng.randint(1, 1000), rng.randint(1, 1000)),
                      "bigq": (rng.randint(1001, 1400), rng.randint(1, 1400)),
                      "bigr": (rng.randint(1, 1400), rng.randint(1001, 1400)),
                      "equal": (rng.randint(1001, 1300),) * 2}[kind]
            q, r, ln = q + ln + qg, r + ln + rg, rng.randint(11, 60)
            if q + ln > qlen or r + ln > rlen:
                break
            chain_.append((q, r, ln))
        out.append(chain_)
    return out


def _rows(guides):
    starts = np.zeros(len(guides) + 1, dtype=np.int64)
    np.cumsum([len(g) for g in guides], out=starts[1:])
    rows = np.array([a for g in guides for a in g],
                    dtype=np.int32).reshape(-1, 3)
    return rows, starts


def _state(al) -> tuple:
    return (al.start_a, al.end_a, al.start_b, al.end_b, al.a, al.b,
            list(al.cigar), al.align_a, al.align_b, al.alignment,
            al.matches(), al.mismatches(), al.gaps(), al.gap_bases())


def _strings(rng: random.Random, n: int) -> tuple[str, str]:
    q = sim.rand_seq(rng, n)
    r = sim.make_small(rng, q, 15)
    r = r + sim.rand_seq(rng, max(0, n - len(r)))
    # lowercase and N runs, as soft-masked assemblies have them
    q = q[:n // 3] + q[n // 3:n // 2].lower() + q[n // 2:]
    r = r[:n // 4] + "N" * 30 + r[n // 4 + 30:]
    return q, r


def _same(guides, q, r, al, ref_al):
    rows, starts = _rows(guides)
    got = Alignment.from_anchors_many(q, r, rows, starts, al)
    want = RefAlignment.from_anchors_many(q, r, guides, ref_al)
    assert len(got) == len(want) == len(guides)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _state(g) == _state(w), i
    return got


@pytest.mark.parametrize("aligner", ["host", "scripted", "tail_I",
                                     "tail_D"])
@pytest.mark.parametrize("seed", range(4))
def test_from_anchors_many_matches_the_reference(seed, aligner):
    rng = random.Random(1000 * seed + len(aligner))
    q, r = _strings(rng, 9000)
    guides = _chains(rng, len(q), len(r), 6)
    al = {"host": AL, "scripted": ScriptedAligner(),
          "tail_I": ScriptedAligner("I"),
          "tail_D": ScriptedAligner("D")}[aligner]
    _same(guides, q, r, al, al)


def test_from_anchors_many_edge_chains():
    """One-anchor chains, adjacent anchors, a chain of one-sided gaps,
    every chain alone as well as together, and no chain."""
    rng = random.Random(5)
    q, r = _strings(rng, 6000)
    guides = [[(10, 20, 30)],
              [(100, 100, 15), (115, 115, 20), (135, 135, 11)],
              [(200, 300, 12), (250, 312, 12), (262, 400, 12),
               (300, 412, 40)],
              [(5000, 5000, 40)]]
    _same(guides, q, r, AL, AL)
    for g in guides:
        _same([g], q, r, AL, AL)
    got = _same([], q, r, AL, AL)
    assert got == []


def test_junctions_merge_only_where_append_cigar_does():
    """A DP ending in ``I`` and the big gap's ``I`` stay two ops; equal
    big sides leave an ``("I", 0)`` that keeps the next anchor's ``M``
    from merging; adjacent anchors' ``M`` runs merge."""
    rng = random.Random(9)
    q, r = _strings(rng, 8000)
    big = [(0, 0, 20), (20 + 500, 20 + 1600, 20)]      # qgap < rgap > 1000
    equal = [(0, 0, 20), (20 + 1200, 20 + 1200, 20)]   # qgap == rgap > 1000
    adjacent = [(0, 0, 20), (20, 20, 20), (40, 40, 20)]
    tail = ScriptedAligner("I")
    got = _same([big, equal, adjacent], q, r, tail, tail)
    assert got[0].cigar[-3:-1] == [("I", 1), ("I", 1100)]
    assert got[1].cigar[-3:] == [("I", 1), ("I", 0), ("M", 20)]
    assert got[2].cigar == [("M", 60)]


def test_populate_without_the_native_lib(monkeypatch):
    """The NumPy ``_populate`` gives the native pass's strings and tallies
    on the same chains, zero-length indels among their ops."""
    rng = random.Random(21)
    q, r = _strings(rng, 9000)
    rows, starts = _rows(_chains(rng, len(q), len(r), 6))
    al = ScriptedAligner("I")
    want = Alignment.from_anchors_many(q, r, rows, starts, al)
    real = native.has
    monkeypatch.setattr(native, "has",
                        lambda name: name != "populate" and real(name))
    got = Alignment.from_anchors_many(q, r, rows, starts, al)
    assert [_state(g) for g in got] == [_state(w) for w in want]
    assert any(ln == 0 for w in want for _, ln in w.cigar)


def test_batch_gap_cigars_matches_the_reference():
    """The list form ``from_guide`` plans its gaps with, on gaps of every
    kind."""
    rng = random.Random(3)
    q, r = _strings(rng, 9000)
    gaps = []
    for g in _chains(rng, len(q), len(r), 8):
        for (q0, r0, l0), (q1, r1, _) in zip(g, g[1:]):
            gaps.append((q0 + l0, q1, r0 + l0, r1))
    assert len(gaps) > 20
    for al in (AL, ScriptedAligner("I")):
        assert (_batch_gap_cigars(q, r, gaps, al)
                == ref_batch_gap_cigars(q, r, gaps, al))
    assert _batch_gap_cigars(q, r, [], AL) == []


def _region(seed: int, n: int, err: int) -> tuple[str, str]:
    rng = random.Random(seed)
    q = sim.rand_seq(rng, n)
    r = sim.make_large(rng, sim.make_small(rng, q, err), err // 2)
    q = q[:n // 5] + q[n // 5:n // 3].lower() + "N" * 40 + q[n // 3:]
    return q, r


def _ref_rows(found) -> list[list[int]]:
    return [[a.q, a.r, a.l, a.has_u] for a in found]


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("seed, n, err, same_chr, k", [
    (1, 3000, 5, False, 11), (2, 6000, 20, False, 11),
    (3, 4000, 10, True, 11), (4, 2500, 0, True, 7), (5, 5000, 15, False, 12),
])
def test_generate_anchors_matches_the_reference(monkeypatch, route, seed, n,
                                                err, same_chr, k):
    if route == "native" and not native.has("anchors"):
        pytest.skip("native lib not built")
    if route == "numpy":
        real = native.has
        monkeypatch.setattr(native, "has",
                            lambda name: name != "anchors" and real(name))
    q, r = _region(seed, n, err)
    got = anchors.generate_anchors(q, r, same_chr, 0, 30, k)
    want = ref_anchors.generate_anchors(q, r, same_chr, 0, 30, k)
    assert got.dtype == np.int32 and got.shape == (len(want), 4)
    assert got.tolist() == _ref_rows(want)
    assert len(want) > 50


def test_generate_anchors_numpy_above_the_native_k():
    """2k > 24 takes the NumPy join whatever the native lib has."""
    q, r = _region(6, 3000, 5)
    got = anchors.generate_anchors(q, r, False, 0, 0, 13)
    assert got.tolist() == _ref_rows(
        ref_anchors.generate_anchors(q, r, False, 0, 0, 13))
    empty = anchors.generate_anchors("ACGT", "ACGT", False, 0, 0, 11)
    assert empty.shape == (0, 4) and empty.dtype == np.int32


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("seed, n, err, same_chr", [
    (11, 3000, 10, False), (12, 5000, 25, False), (13, 4000, 15, True),
    (14, 2000, 0, False),
])
def test_chain_anchors_matches_the_reference(use_native, seed, n, err,
                                             same_chr):
    if use_native and not native.has("chain"):
        pytest.skip("native lib not built")
    q, r = _region(seed, n, err)
    found = ref_anchors.generate_anchors(q, r, same_chr, 0, 0, 11)
    rows = np.array(_ref_rows(found), dtype=np.int32).reshape(-1, 4)
    path, bounds = chain.chain_anchors(rows, use_native=use_native)
    want_path, want_bounds = ref_chain.chain_anchors(found,
                                                     use_native=use_native)
    assert path.tolist() == list(want_path)
    assert [tuple(b) for b in bounds.tolist()] == list(want_bounds)
    assert bounds.shape == (len(want_bounds), 2)


def test_chain_anchors_of_no_anchors():
    for use_native in (True, False):
        path, bounds = chain.chain_anchors(np.empty((0, 4), np.int32),
                                           use_native=use_native)
        assert path.tolist() == [] and bounds.tolist() == [[0, 0]]
