"""The port's CIGAR surgery (``sedef_tpu_torch/ops/cigar.py``) under
``tests/test_cigar_fuzz.py``'s fuzzers, held against the reference
package's: random mutated pairs through from_seqs, trim_front /
trim_back / trim, merge and from_cigar round trips keep the structural
invariants, and give the coordinates, op lists and gapped strings of
``sedef_tpu.ops.cigar`` on the same inputs; the live-oracle fuzz's 240
cases are held against the reference package's surgery in place of the
compiled reference binary.  Every gap DP of the port runs on its CPU
aligner.  Tolerance: exact equality."""

import numpy as np
import torch

from sedef_tpu.config import DEFAULT as REF_DEFAULT
from sedef_tpu.ops.cigar import Alignment as RefAlignment
from sedef_tpu.ops.wavefront import WavefrontAligner as RefAligner
from sedef_tpu_torch.config import DEFAULT
from sedef_tpu_torch.ops.cigar import Alignment
from sedef_tpu_torch.ops.wavefront import WavefrontAligner

from test_cigar_fuzz import check_consistent, mutate, rand_pair

torch.set_num_threads(1)

AL = WavefrontAligner(device="cpu")
REF_AL = RefAligner(use_tpu=False)


def _state(al) -> tuple:
    return (al.start_a, al.end_a, al.start_b, al.end_b, list(al.cigar),
            al.align_a, al.align_b, al.alignment)


def _line(al) -> str:
    cig = al.cigar_string()
    return (f"{al.start_a} {al.end_a} {al.start_b} {al.end_b} "
            f"{cig if cig else '.'}")


def test_fuzz_trims():
    for seed in range(12):
        rng = np.random.default_rng(seed)
        q, r = rand_pair(rng, rate=0.05 + 0.025 * (seed % 8))
        al = Alignment.from_seqs(q, r, AL)
        ref = RefAlignment.from_seqs(q, r, REF_AL)
        check_consistent(al, f"from_seqs[{seed}]")
        assert _state(al) == _state(ref), seed
        f, rf = al.copy(), ref.copy()
        f.trim_front(DEFAULT)
        rf.trim_front(REF_DEFAULT)
        check_consistent(f, f"trim_front[{seed}]")
        assert _state(f) == _state(rf), seed
        assert f.start_a >= al.start_a and f.start_b >= al.start_b
        assert f.end_a == al.end_a and f.end_b == al.end_b
        b, rb = al.copy(), ref.copy()
        b.trim_back(DEFAULT)
        rb.trim_back(REF_DEFAULT)
        check_consistent(b, f"trim_back[{seed}]")
        assert _state(b) == _state(rb), seed
        assert b.end_a <= al.end_a and b.end_b <= al.end_b
        assert b.start_a == al.start_a and b.start_b == al.start_b
        f.trim_back(DEFAULT)
        rf.trim_back(REF_DEFAULT)
        check_consistent(f, f"trim_both[{seed}]")
        assert _state(f) == _state(rf), seed


def test_fuzz_cigar_roundtrip():
    for seed in range(8):
        rng = np.random.default_rng(100 + seed)
        q, r = rand_pair(rng, n=1500)
        al = Alignment.from_seqs(q, r, AL)
        rt = Alignment.from_cigar(al.a, al.b, al.cigar_string())
        ref = RefAlignment.from_cigar(al.a, al.b, al.cigar_string())
        assert rt.cigar == al.cigar == ref.cigar
        assert rt.align_a == al.align_a == ref.align_a
        assert rt.align_b == al.align_b == ref.align_b
        counts = (rt.matches(), rt.mismatches(), rt.gaps(), rt.gap_bases())
        assert counts == (al.matches(), al.mismatches(), al.gaps(),
                          al.gap_bases())
        assert counts == (ref.matches(), ref.mismatches(), ref.gaps(),
                          ref.gap_bases())
        assert rt.total_error() == ref.total_error()


def test_fuzz_merge():
    """Overlapping block merge: absolute coordinates, de-gap identity and
    full-span coverage survive the double cut + gap re-alignment, and the
    merged alignment is the reference package's."""
    for seed in range(10):
        rng = np.random.default_rng(200 + seed)
        q, r = rand_pair(rng, n=3400, rate=0.04 + 0.02 * (seed % 4))
        cut_q = 1700 + int(rng.integers(-200, 200))
        cut_r = min(cut_q + int(rng.integers(-60, 60)), len(r) - 400)
        ov = int(rng.integers(40, 400))
        merged = []
        for cls, aligner in ((Alignment, AL), (RefAlignment, REF_AL)):
            first = cls.from_seqs(q[:cut_q], r[:cut_r], aligner)
            cur = cls.from_seqs(q[cut_q - ov:], r[cut_r - ov:], aligner)
            cur.start_a += cut_q - ov
            cur.end_a += cut_q - ov
            cur.start_b += cut_r - ov
            cur.end_b += cut_r - ov
            assert cur.start_a < first.end_a  # genuine overlap
            first.merge(cur, q, r, aligner)
            merged.append(first)
        first = merged[0]
        check_consistent(first, f"merge[{seed}]")
        assert first.start_a == 0 and first.start_b == 0
        assert first.end_a == len(q) and first.end_b == len(r)
        assert first.a == q and first.b == r
        assert _state(first) == _state(merged[1]), seed


def test_empty_rebuild_sentinel_blocks_coalescing():
    """align.cc:501 quirk, as the reference package keeps it: the empty
    alignment's {'\\0', 0} run blocks append_cigar's junction merge."""
    for cls in (Alignment, RefAlignment):
        al = cls()
        al.cigar_from_alignment()
        assert al.cigar == [("\x00", 0)]
        left = cls.from_cigar("A" * 58, "A" * 58, "58M")
        left.append_cigar(al.cigar)
        left.append_cigar([("M", 62)])
        assert left.cigar == [("M", 58), ("\x00", 0), ("M", 62)]
        assert left.cigar_string() == "58M62M"
        left.a = "A" * 120
        left.b = "A" * 120
        left.populate()
        assert left.gaps() == 1 and left.gap_bases() == 0


def test_pretty_render():
    al = Alignment.from_cigar("ACGTACGTAA", "ACCTACGT", "4M2D4M")
    ref = RefAlignment.from_cigar("ACGTACGTAA", "ACCTACGT", "4M2D4M")
    for width in (6, 80):
        assert al.pretty(width=width) == ref.pretty(width=width)
    s = al.pretty(width=6).splitlines()
    assert s[2].startswith("   CIGAR: 4M2D4M")
    assert "ACGTAC" in s[3] and "ACCT--" in s[5]
    only = al.pretty(width=-1, only_alignment=True)
    assert only == ref.pretty(width=-1, only_alignment=True)
    assert only.splitlines()[0] == "ACGTACGTAA"
    assert only.splitlines()[2] == "ACCT--ACGT"


def test_fuzz_surgery_vs_reference_package():
    """The live-oracle fuzz's >= 200 trim / merge cases (same seed, same
    case mix), the port's coordinates and CIGAR against the reference
    package's."""
    rng = np.random.default_rng(42)
    got: list[str] = []
    want: list[str] = []
    for i in range(60):
        n = int(rng.integers(400, 1200))
        rate = 0.03 + 0.17 * (i % 7) / 6
        q = "".join(rng.choice(list("ACGT"), n))
        r = mutate(q, rate, rng)
        cig = Alignment.from_seqs(q, r, AL).cigar_string()
        assert cig == RefAlignment.from_seqs(q, r, REF_AL).cigar_string()
        for op in ("trim_front", "trim_back", "trim"):
            for cls, cfg, out in ((Alignment, DEFAULT, got),
                                  (RefAlignment, REF_DEFAULT, want)):
                al = cls.from_cigar(q, r, cig)
                getattr(al, op)() if op == "trim" else getattr(al, op)(cfg)
                out.append(_line(al))
    merges = 0
    while merges < 60:
        n = int(rng.integers(1600, 2600))
        q = "".join(rng.choice(list("ACGT"), n))
        r = mutate(q, 0.03 + 0.05 * (merges % 3), rng)
        cut_q = n // 2 + int(rng.integers(-150, 150))
        cut_r = min(cut_q + int(rng.integers(-40, 40)), len(r) - 300)
        ov = int(rng.integers(40, 300))
        if cut_r - ov <= 0:
            continue
        res = []
        for cls, aligner in ((Alignment, AL), (RefAlignment, REF_AL)):
            first = cls.from_seqs(q[:cut_q], r[:cut_r], aligner)
            cur = cls.from_seqs(q[cut_q - ov:], r[cut_r - ov:], aligner)
            cur.start_a += cut_q - ov
            cur.end_a += cut_q - ov
            cur.start_b += cut_r - ov
            cur.end_b += cut_r - ov
            if not (cur.start_a < first.end_a or cur.start_b < first.end_b):
                break
            first.merge(cur, q, r, aligner)
            res.append(first)
        if len(res) < 2:
            continue
        check_consistent(res[0], f"oracle_merge[{merges}]")
        got.append(_line(res[0]))
        want.append(_line(res[1]))
        merges += 1
    assert len(got) == len(want) >= 200
    bad = [(i, got[i], want[i]) for i in range(len(got)) if got[i] != want[i]]
    assert not bad, f"{len(bad)} divergences; first: {bad[0]}"
