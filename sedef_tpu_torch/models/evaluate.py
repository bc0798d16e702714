"""Counterpart of ``sedef_tpu/models/evaluate.py``.

Evaluation against gold-standard SD calls (WGAC).

Equivalents of the reference's two comparison tools:

* :func:`diff` — per-base bitset intersection of our calls vs a WGAC
  table (``sedef stats diff``, stats_main.cc:397-509), vectorized with
  NumPy boolean arrays instead of boost::dynamic_bitset.
* :func:`check_overlap` — per-SD Missed / Partial / Full classification
  with reciprocal-coverage accounting (``scratch/check-overlap.py``,
  bedtools pairtopair -type both semantics done in-process).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from ..io.bed import Hit
from ..io.fasta import FastaReference
from ..ops.dna import uppercase_mask


@dataclass
class DiffResult:
    sedef_span: int = 0
    sedef_only: int = 0
    sedef_extra_upper: int = 0
    wgac_only: int = 0
    miss_upper: int = 0
    wgac_span: int = 0
    intersect: int = 0

    def report(self) -> str:
        return (f"SEDEF: spans              {self.sedef_span:12,}\n"
                f"       unique             {self.sedef_only:12,}\n"
                f"       unique (uppercase) {self.sedef_extra_upper:12,}\n"
                f"       misses             {self.wgac_only:12,}\n"
                f"       misses (uppercase) {self.miss_upper:12,}\n"
                f"WGAC:  spans              {self.wgac_span:12,}\n"
                f"       intersects         {self.intersect:12,}")


def _isupper_count(seq: str) -> int:
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return int(((raw >= 65) & (raw <= 90)).sum())


def _mark(bits: dict, name: str, length: int, s: int, e: int) -> None:
    if name not in bits:
        bits[name] = np.zeros(length, dtype=bool)
    bits[name][max(0, s):max(0, e)] = True


def diff(fr: FastaReference, bed_lines: list[str], wgac_lines: list[str],
         min_upper: int = 100) -> DiffResult:
    """stats_main.cc:397-509 semantics: mark per-base coverage of both call
    sets (both mates), dropping our calls whose either mate has < 100
    uppercase bases; report spans/unique/missed (total and uppercase)."""
    sedef: dict[str, np.ndarray] = {}
    wgac: dict[str, np.ndarray] = {}

    for line in bed_lines:
        if not line.strip() or line.startswith("#"):
            continue
        h, _ = Hit.from_bed(line)
        qlen = fr.length(h.query.name)
        rlen = fr.length(h.ref.name)
        qe = min(h.query_end, qlen)
        re_ = min(h.ref_end, rlen)
        fa = fr.get_sequence(h.query.name, h.query_start, qe)
        fb = fr.get_sequence(h.ref.name, h.ref_start, re_)
        # the filter counts isupper() bases — uppercase 'N' INCLUDED
        # (stats_main.cc:416-425), unlike the informative mask below
        if (_isupper_count(fa) < min_upper
                or _isupper_count(fb) < min_upper):
            continue
        _mark(sedef, h.query.name, qlen, h.query_start, qe)
        _mark(sedef, h.ref.name, rlen, h.ref_start, re_)

    seen: set[str] = set()
    for line in wgac_lines[1:]:  # header skipped like the reference
        if not line.strip():
            continue
        h = Hit.from_wgac(line)
        if len(h.query.name) > 6 or len(h.ref.name) > 6:
            continue  # reference's alt-contig filter (stats_main.cc:452)
        if h.name in seen:
            continue
        seen.add(h.name)
        _mark(wgac, h.query.name, fr.length(h.query.name),
              h.query_start, h.query_end)
        _mark(wgac, h.ref.name, fr.length(h.ref.name),
              h.ref_start, h.ref_end)

    res = DiffResult()
    for name, s in sedef.items():
        w = wgac.get(name)
        if w is None:
            w = np.zeros_like(s)
        seq = fr.get_sequence(name)
        up = uppercase_mask(seq)
        nn = np.frombuffer(seq.upper().encode(), np.uint8) != ord("N")
        informative = up & nn
        res.sedef_extra_upper += int((s & ~w & informative).sum())
        res.miss_upper += int((w & ~s & informative).sum())
        res.intersect += int((s & w).sum())
        res.wgac_only += int((w & ~s).sum())
        res.sedef_only += int((s & ~w).sum())
        res.sedef_span += int(s.sum())
        res.wgac_span += int(w.sum())
    return res


@dataclass
class OverlapResult:
    full: int = 0
    partial: int = 0
    missed: int = 0
    missed_bases: int = 0
    total_bases: int = 0
    missed_list: list = field(default_factory=list)

    def report(self) -> str:
        total = self.full + self.partial + self.missed
        return (f"WGAC SDs: {total}  Full: {self.full}  "
                f"Partial: {self.partial}  Missed: {self.missed}  "
                f"missed bases: {self.missed_bases:,}/{self.total_bases:,}")


def _pair_key(c1, s1, e1, c2, s2, e2):
    a = (c1, s1, e1)
    b = (c2, s2, e2)
    return (a, b) if a <= b else (b, a)


def check_overlap(final_lines: list[str], wgac_lines: list[str],
                  min_coverage: float = 0.8) -> OverlapResult:
    """check-overlap.py semantics: pair every WGAC SD with our calls that
    overlap BOTH mates (pairtopair -type both); classify Full if some
    pairing covers >= min_coverage of both WGAC mates (reciprocal
    coverage accumulated over all overlapping calls), Partial if covered
    at all, else Missed."""
    calls_by_chr: dict[tuple[str, str], list[tuple]] = defaultdict(list)
    for line in final_lines:
        if not line.strip() or line.startswith("#"):
            continue
        f = line.split("\t")
        c1, s1, e1 = f[0], int(f[1]), int(f[2])
        c2, s2, e2 = f[3], int(f[4]), int(f[5])
        calls_by_chr[(c1, c2)].append((s1, e1, s2, e2))
        calls_by_chr[(c2, c1)].append((s2, e2, s1, e1))

    res = OverlapResult()
    seen: set = set()
    for line in wgac_lines[1:]:
        if not line.strip():
            continue
        h = Hit.from_wgac(line)
        key = _pair_key(h.query.name, h.query_start, h.query_end,
                        h.ref.name, h.ref_start, h.ref_end)
        if key in seen:
            continue
        seen.add(key)
        la = h.query_end - h.query_start
        lb = h.ref_end - h.ref_start
        res.total_bases += la + lb
        cov_a = np.zeros(la, dtype=bool)
        cov_b = np.zeros(lb, dtype=bool)
        for (s1, e1, s2, e2) in calls_by_chr.get(
                (h.query.name, h.ref.name), []):
            oa = (max(s1, h.query_start), min(e1, h.query_end))
            ob = (max(s2, h.ref_start), min(e2, h.ref_end))
            if oa[0] < oa[1] and ob[0] < ob[1]:
                cov_a[oa[0] - h.query_start:oa[1] - h.query_start] = True
                cov_b[ob[0] - h.ref_start:ob[1] - h.ref_start] = True
        ca = cov_a.sum() / max(la, 1)
        cb = cov_b.sum() / max(lb, 1)
        if ca >= min_coverage and cb >= min_coverage:
            res.full += 1
        elif ca > 0 or cb > 0:
            res.partial += 1
            res.missed_bases += int(la - cov_a.sum() + lb - cov_b.sum())
        else:
            res.missed += 1
            res.missed_bases += la + lb
            res.missed_list.append(key)
    return res
