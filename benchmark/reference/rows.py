"""Alignment rows judged by what they say, in plain NumPy.

A row names two intervals and a CIGAR.  Its CIGAR has to take exactly the
two intervals' bases (the second reverse-complemented on a ``-`` strand),
and every tally and statistic it prints has to be the one that CIGAR gives
over those bases, by SEDEF's definitions (``align.cc`` for the error
columns, ``stats_main.cc`` for ``final.bed``'s).  A final row also has to
pass the filters the configuration states.
"""

from __future__ import annotations

import math
import re

import numpy as np

_DASH = ord("-")
_N = ord("N")
_RC = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")
_CIGAR = re.compile(r"(\d+)([MID])")


def revcomp(s: bytes) -> bytes:
    return s.translate(_RC)[::-1]


def read_fasta(path: str) -> dict[str, bytes]:
    out: dict[str, list[bytes]] = {}
    name = None
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                name = line[1:].split()[0].decode()
                out[name] = []
            elif name is not None:
                out[name].append(line)
    return {n: b"".join(p) for n, p in out.items()}


def parse_cigar(s: str) -> list[tuple[str, int]] | None:
    """(op, length) runs of a CIGAR string; None where it is not one."""
    ops = [(op, int(n)) for n, op in _CIGAR.findall(s)]
    return ops if "".join(f"{n}{op}" for op, n in ops) == s else None


def gapped(a: bytes, b: bytes, cigar) -> tuple[np.ndarray, np.ndarray] | None:
    """The alignment's two gapped rows of bytes ('-' in a gap), or None
    where the CIGAR does not take exactly the bases of a and b."""
    qa = sum(n for op, n in cigar if op in "MD")
    qb = sum(n for op, n in cigar if op in "MI")
    if qa != len(a) or qb != len(b):
        return None
    av = np.frombuffer(a, dtype=np.uint8)
    bv = np.frombuffer(b, dtype=np.uint8)
    ga, gb = [], []
    i = j = 0
    for op, n in cigar:
        if op == "M":
            ga.append(av[i:i + n])
            gb.append(bv[j:j + n])
            i += n
            j += n
        elif op == "D":
            ga.append(av[i:i + n])
            gb.append(np.full(n, _DASH, dtype=np.uint8))
            i += n
        else:
            ga.append(np.full(n, _DASH, dtype=np.uint8))
            gb.append(bv[j:j + n])
            j += n
    if not ga:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    return np.concatenate(ga), np.concatenate(gb)


def _upper(x: np.ndarray) -> np.ndarray:
    return np.where((x >= 97) & (x <= 122), x - 32, x)


def error_tallies(ga: np.ndarray, gb: np.ndarray, cigar) -> dict:
    """align.cc's tallies: a match is a column of two equal bases (either
    case) neither of which is N; a mismatch any other column of two bases;
    gap bases the gap columns; gaps the gap runs."""
    au, bu = _upper(ga), _upper(gb)
    both = (ga != _DASH) & (gb != _DASH)
    eq = both & (au != _N) & (bu != _N) & (au == bu)
    return {"matches": int(eq.sum()), "mismatches": int((both & ~eq).sum()),
            "gap_bases": sum(n for op, n in cigar if op != "M"),
            "gaps": sum(1 for op, n in cigar if op != "M" and n),
            "span": len(ga)}


def errors(t: dict) -> tuple[float, float]:
    """(mismatch %, gap %) of the tallies: over matches, mismatches and
    gap bases."""
    d = t["matches"] + t["mismatches"] + t["gap_bases"]
    if not d:
        return 0.0, 0.0
    return 100.0 * t["mismatches"] / d, 100.0 * t["gap_bases"] / d


def _near(printed: str, value: float, places: int | None = None) -> bool:
    """A printed number against the value it stands for: to the printed
    decimals, or to %g's six significant digits."""
    try:
        got = float(printed)
    except ValueError:
        return False
    if math.isnan(value) or math.isnan(got):
        return math.isnan(value) and math.isnan(got)
    if math.isinf(value) or math.isinf(got):
        return got == value
    if places is not None:
        return abs(got - value) <= 0.5 * 10 ** -places + 1e-9
    return abs(got - value) <= 6e-6 * max(abs(value), 1e-300) + 1e-12


def sequences(f: list[str], genome: dict[str, bytes]):
    """The two intervals' bases a row names, or None where it names none."""
    try:
        qa = genome[f[0]][int(f[1]):int(f[2])]
        b = genome[f[3]][int(f[4]):int(f[5])]
    except (KeyError, ValueError):
        return None
    if int(f[2]) > len(genome[f[0]]) or int(f[5]) > len(genome[f[3]]):
        return None
    return qa, (revcomp(b) if f[9] == "-" else b)


def aligned_row_faults(line: str, genome: dict[str, bytes]) -> int:
    """0 where an ``aligned.bed`` row holds: its CIGAR takes its two
    intervals' bases, and its error columns (score, max_len, span, m=, g=)
    are what that CIGAR gives; 1 otherwise."""
    f = line.split("\t")
    if len(f) < 14:
        return 1
    seqs = sequences(f, genome)
    cig = parse_cigar(f[12])
    if seqs is None or cig is None:
        return 1
    g = gapped(*seqs, cig)
    if g is None:
        return 1
    t = error_tallies(*g, cig)
    m, gp = errors(t)
    want = f"m={m:.1f};g={gp:.1f}"
    ok = (_near(f[7], m + gp, 1) and int(f[11]) == t["span"]
          and int(f[10]) == max(len(seqs[0]), len(seqs[1]))
          and f[13].split(";")[:2] == want.split(";"))
    return 0 if ok else 1


def final_columns(ga: np.ndarray, gb: np.ndarray, cigar) -> dict:
    """stats_main.cc's per-row statistics of an alignment."""
    au, bu = _upper(ga), _upper(gb)
    a_gap, b_gap = au == _DASH, bu == _DASH
    both = ~a_gap & ~b_gap
    upper_a = (ga >= 65) & (ga <= 90)
    upper_b = (gb >= 65) & (gb <= 90)
    mism = both & (au != bu)
    a_pur = (au == ord("A")) | (au == ord("G"))
    b_pur = (bu == ord("A")) | (bu == ord("G"))
    b_pyr = (bu == ord("C")) | (bu == ord("T"))
    align_b = int(both.sum())
    match_b = int((~a_gap & (au == bu)).sum())
    mismatch_b = int(mism.sum())
    ts = int((mism & np.where(a_pur, b_pur, b_pyr)).sum())
    tv = int((mism & np.where(a_pur, ~b_pur, ~b_pyr)).sum())
    nan = float("nan")
    jcp = mismatch_b / align_b if align_b else nan
    jck = (-0.75 * math.log(1.0 - 4.0 / 3 * jcp)
           if 1.0 - 4.0 / 3 * jcp > 0 else float("inf"))
    p = ts / align_b if align_b else nan
    qv = tv / align_b if align_b else nan
    w1d, w2d = 1 - 2.0 * p - qv, 1 - 2.0 * qv
    if w1d == 0 or w2d == 0:
        k2k = float("inf")
    else:
        w1, w2 = 1.0 / w1d, 1.0 / w2d
        k2k = (0.5 * math.log(w1) + 0.25 * math.log(w2)
               if w1 > 0 and w2 > 0 else nan)
    t = error_tallies(ga, gb, cigar)
    denom = t["gaps"] + t["mismatches"] + t["matches"]
    scaled = (t["gaps"] + t["mismatches"]) / denom if denom else 0.0
    return {
        "indel_a": int(a_gap.sum()), "indel_b": int(b_gap.sum()),
        "alnB": align_b, "matchB": match_b, "mismatchB": mismatch_b,
        "transitionsB": ts, "transversionsB": tv,
        "fracMatch": match_b / align_b if align_b else nan,
        "fracMatchIndel": match_b / len(ga) if len(ga) else nan,
        "jcK": jck, "k2K": k2k,
        "uppercaseA": int((~a_gap & (au != _N) & upper_a).sum()),
        "uppercaseB": int((~b_gap & (bu != _N) & upper_b).sum()),
        "uppercaseMatches": int((both & (au == bu) & upper_a
                                 & upper_b).sum()),
        "error_scaled": scaled, **t}


# final.bed's columns after the cigar-less BED part (0-12), in order
_FINAL_INTS = ("indel_a", "indel_b", "alnB", "matchB", "mismatchB",
               "transitionsB", "transversionsB")
_FINAL_FLOATS = ("fracMatch", "fracMatchIndel", "jcK", "k2K")
_FINAL_TAIL = ("gaps", "uppercaseA", "uppercaseB", "uppercaseMatches",
               "matches", "mismatches", "gaps", "gap_bases")


def final_row_faults(line: str, genome: dict[str, bytes],
                     filters: dict) -> int:
    """0 where a ``final.bed`` row holds: its CIGAR takes its intervals'
    bases, every statistic it prints is the one that CIGAR gives, and it
    passes the configuration's filters; 1 otherwise."""
    f = line.split("\t")
    if len(f) != 34:
        return 1
    seqs = sequences(f, genome)
    cig = parse_cigar(f[32])
    if seqs is None or cig is None:
        return 1
    g = gapped(*seqs, cig)
    if g is None:
        return 1
    c = final_columns(*g, cig)
    m, gp = errors(c)
    ok = (_near(f[7], m + gp, 1) and int(f[11]) == c["span"]
          and f[12] == f"m={m:.1f};g={gp:.1f}"
          and int(f[10]) == max(len(seqs[0]), len(seqs[1])))
    ok &= all(int(f[13 + i]) == c[k] for i, k in enumerate(_FINAL_INTS))
    ok &= all(_near(f[20 + i], c[k]) for i, k in enumerate(_FINAL_FLOATS))
    ok &= all(int(f[24 + i]) == c[k] for i, k in enumerate(_FINAL_TAIL))
    ok &= _near(f[33], 1 - c["error_scaled"])
    # the filters (stats_main.cc:300-330)
    q0, q1, r0, r1 = int(f[1]), int(f[2]), int(f[4]), int(f[5])
    same = f[0] == f[3] and f[8] == f[9]
    overlap = max(0, min(q1, r1) - max(q0, r0)) if same else 0
    ok &= c["span"] >= filters["min_read"]
    ok &= min(c["uppercaseA"], c["uppercaseB"],
              c["uppercaseMatches"]) >= filters["min_uppercase"]
    ok &= c["error_scaled"] <= filters["max_scaled_error"]
    ok &= not (same and (q1 - q0 - overlap < filters["big_overlap"]
                         or r1 - r0 - overlap < filters["big_overlap"]))
    return 0 if ok else 1


def hit_faults(a: str, b: str, hit) -> int:
    """0 where a pair's chain hit holds: coordinates inside the two
    sequences it was chained over, a CIGAR that takes exactly those bases,
    and the tallies that CIGAR gives there; 1 otherwise."""
    qs, qe, rs, re_ = hit.query_start, hit.query_end, hit.ref_start, \
        hit.ref_end
    if not (0 <= qs <= qe <= len(a) and 0 <= rs <= re_ <= len(b)):
        return 1
    cig = [(op, int(n)) for op, n in hit.aln.cigar if n]
    if any(op not in "MID" for op, _ in cig):
        return 1
    g = gapped(a[qs:qe].encode(), b[rs:re_].encode(), cig)
    if g is None:
        return 1
    t = error_tallies(*g, cig)
    al = hit.aln
    ok = (al.matches() == t["matches"] and al.mismatches() == t["mismatches"]
          and al.gap_bases() == t["gap_bases"])
    return 0 if ok else 1
