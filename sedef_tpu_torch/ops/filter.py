"""Counterpart of ``sedef_tpu/ops/filter.py``.

Seed-hit filters: uppercase content and q-gram lemma.

Equivalent of ``src/filter.cc``: the uppercase filter requires >=
MIN_UPPERCASE unmasked characters on each side (filter.cc:37-53); the
q-gram filter lower-bounds the shared-5-gram count by
``l*(1 - p_G - q*p_E) - (G*l + 1)*(q - 1)`` (filter.cc:28-33, 55-91).

Array formulation: per-window 1024-bin histograms via ``np.bincount`` over
packed 5-gram codes, shared count = sum of per-bin minima — batched across
many windows on device later (qgram histograms are a natural segment-sum).
"""

from __future__ import annotations

import numpy as np

from .. import trace
from ..config import DEFAULT, Config
from .dna import CLS_UPPER, PackedSeq

QG = 5
QSZ = 1 << (2 * QG)
_MASK = QSZ - 1


# funnel counters (search_main.cc:186-193 report); the ``-j`` fan-out adds
# to them from pool threads
COUNTERS = trace.Counters("funnel", ("total", "jaccard", "interval",
                                     "lowercase", "qgram"))


def min_qgram(l: int, q: int, cfg: Config = DEFAULT) -> int:
    s = cfg.search
    return int(l * (1 - (s.max_error - s.max_edit_error)
                    - q * s.max_edit_error)
               - (s.gap_frequency * l + 1) * (q - 1))


def uppercase_count(seq: PackedSeq, start: int, end: int) -> int:
    return int((seq.cls[start:end] == CLS_UPPER).sum())


def _qgram_hist(code: np.ndarray) -> np.ndarray:
    n = code.shape[0] - QG + 1
    if n <= 0:
        return np.zeros(QSZ, dtype=np.int32)
    g = np.zeros(n, dtype=np.int32)
    for j in range(QG):
        g = (g << 2) | code[j:j + n].astype(np.int32)
    return np.bincount(g, minlength=QSZ).astype(np.int32)


def filter_hit(qseq: PackedSeq, q_start: int, q_end: int,
               rseq: PackedSeq, r_start: int, r_end: int,
               cfg: Config = DEFAULT) -> tuple[bool, str]:
    """Combined filter (filter.cc:95-110). Returns (ok, reason)."""
    if cfg.internal.do_uppercase:
        q_up = uppercase_count(qseq, q_start, q_end)
        r_up = uppercase_count(rseq, r_start, r_end)
        if q_up < cfg.search.min_uppercase or r_up < cfg.search.min_uppercase:
            COUNTERS.add("lowercase")
            return False, f"upper ({q_up}, {r_up}) < {cfg.search.min_uppercase}"

    if cfg.internal.do_qgram:
        maxlen = max(q_end - q_start, r_end - r_start)
        minqg = min_qgram(maxlen, QG, cfg)
        assert minqg >= 10, "q-gram bound degenerate for this window size"
        hq = _qgram_hist(qseq.code[q_start:q_end])
        hr = _qgram_hist(rseq.code[r_start:r_end])
        dist = int(np.minimum(hq, hr).sum())
        if dist < minqg:
            COUNTERS.add("qgram")
            return False, f"q-grams {dist} < {minqg}"
    return True, ""
