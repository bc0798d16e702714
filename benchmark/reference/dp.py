"""A gap DP judged by its score: the optimum of the global affine-gap
recurrence and the score of a given path, in plain NumPy.

The recurrence is SEDEF's gap DP (ksw2 ``extz2``, global): a column of two
bases scores ``match`` or ``mismatch``, and 0 where either base is not one
of ACGT (a wildcard); a run of L gap columns costs ``gap_open + L *
gap_ext``.  Ties between paths do not matter: a path is judged by its
score alone.
"""

from __future__ import annotations

import numpy as np

NEG = -(1 << 40)

# ACGT in either case -> 0..3, anything else -> 4 (the wildcard)
CODE = np.full(256, 4, dtype=np.int8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i
    CODE[_c + 32] = _i


def codes(seq) -> np.ndarray:
    """Codes 0..4 of a str or bytes sequence."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return CODE[np.frombuffer(seq, dtype=np.uint8)]


def column_scores(q: np.ndarray, t: np.ndarray, sc: dict) -> np.ndarray:
    """Scores of aligned columns q[i] : t[i]."""
    s = np.where(q == t, sc["match"], sc["mismatch"])
    return np.where((q == 4) | (t == 4), 0, s)


def best_score(q: np.ndarray, t: np.ndarray, sc: dict) -> int:
    """The optimum of the global recurrence over q (rows) and t."""
    q = np.asarray(q, dtype=np.int8)
    t = np.asarray(t, dtype=np.int8)
    if len(q) > len(t):  # the scores are symmetric: the longer as columns
        q, t = t, q
    o, e = sc["gap_open"], sc["gap_ext"]
    n, m = len(q), len(t)
    if n == 0:
        return -(o + e * m) if m else 0
    j = np.arange(m + 1, dtype=np.int64)
    ej = e * j
    h = -(o + ej)
    h[0] = 0
    f = np.full(m + 1, NEG, dtype=np.int64)
    rows = column_scores(np.arange(5, dtype=np.int8)[:, None],
                         t[None, :], sc).astype(np.int64)
    d = np.empty(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        f = np.maximum(h - o - e, f - e)           # a gap in t, from above
        d[0] = -(o + e * i)
        np.maximum(h[:-1] + rows[q[i - 1]], f[1:], out=d[1:])
        # a gap in q along the row, opened after any column k < j
        c = np.maximum.accumulate(d + ej)
        h = d.copy()
        np.maximum(h[1:], c[:-1] - o - ej[1:], out=h[1:])
    return int(h[m])


def runs(cigar) -> list[tuple[str, int]]:
    """(op, length) runs of a CIGAR, zero lengths dropped, equal
    neighbours joined."""
    out: list[list] = []
    for op, ln in cigar:
        if not ln:
            continue
        if out and out[-1][0] == op:
            out[-1][1] += ln
        else:
            out.append([op, int(ln)])
    return [(op, ln) for op, ln in out]


def spans(cigar) -> tuple[int, int]:
    """Bases of the query (M, D) and of the target (M, I) a CIGAR takes."""
    qn = sum(ln for op, ln in cigar if op in "MD")
    tn = sum(ln for op, ln in cigar if op in "MI")
    return qn, tn


def path_score(q: np.ndarray, t: np.ndarray, cigar, sc: dict) -> int | None:
    """The score of the path a CIGAR takes through q and t; None where it
    is not an alignment of the two (another op, or other lengths)."""
    rs = runs(cigar)
    if any(op not in "MDI" for op, _ in rs) or spans(rs) != (len(q), len(t)):
        return None
    total = 0
    i = j = 0
    for op, ln in rs:
        if op == "M":
            total += int(column_scores(q[i:i + ln], t[j:j + ln], sc).sum())
            i += ln
            j += ln
        else:
            total -= sc["gap_open"] + sc["gap_ext"] * ln
            if op == "D":
                i += ln
            else:
                j += ln
    return total


def deficit(q: np.ndarray, t: np.ndarray, cigar, sc: dict) -> int | None:
    """How far a gap DP's answer scores below the optimum (0: optimal);
    None where the answer is no alignment of its inputs."""
    got = path_score(q, t, cigar, sc)
    return None if got is None else best_score(q, t, sc) - got
