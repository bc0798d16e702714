"""SD pairs in the regime of SEDEF's simulation (python/simulations.py:53-151).

A NumPy rewrite of ``sedef_tpu_torch/models/simulate.py``'s
``generate_random_sd`` / ``make_small`` / ``make_large`` at commit a1f3aa7,
same regime: a random first copy of length U[min_len, max_len]; an integer
error rate e; a small-mutation share randint(max(0, e-15), min(15, e)) of
SNPs and 1 bp indels (delete e//3 %, insert e//3 %, SNP the rest of e %);
the rest of e as up to ten >= 50 bp indels.  Lengths and rates are drawn
from evenly spaced strata of their ranges over the pool, shuffled, so that
every seed's pool holds nearly the same work in another order.
"""

from __future__ import annotations

import numpy as np

from generators.sim_genome import entropy

LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_small(rng, seq: np.ndarray, error: int) -> np.ndarray:
    """Per base: an action in 1..100; <= e//3 deletes it, <= 2e//3 inserts
    a random base before it, <= e replaces it (SNP)."""
    n = len(seq)
    action = rng.integers(1, 101, n)
    keep = action > error // 3
    ins = keep & (action <= 2 * error // 3)
    snp = (action > 2 * error // 3) & (action <= error)
    out = seq.copy()
    out[snp] = (out[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    # every kept base is preceded by its insert, where it has one
    width = keep.astype(np.int64) + ins
    pos = np.cumsum(width) - 1
    res = np.empty(int(width.sum()), dtype=seq.dtype)
    res[pos[keep]] = out[keep]
    res[pos[ins] - 1] = rng.integers(0, 4, int(ins.sum()))
    return res


def make_large(rng, seq: np.ndarray, error: int) -> np.ndarray:
    """Large (>= 50 bp) indels totalling ~error percent."""
    length = len(seq)
    budget = error * length // 100
    inserts: list[tuple[int, int]] = []
    deletes: list[tuple[int, int]] = []

    def ok(start: int, end: int) -> bool:
        if end > length:
            return False
        if any(start <= s <= end for s, _ in inserts):
            return False
        return not any(start <= s <= end or s <= start <= s + ln
                       for s, ln in deletes)

    counter = 0
    while budget > 50 and counter < 10:
        counter += 1
        gap = int(rng.integers(50, budget + 1))
        action = int(rng.integers(0, 2))  # 0: insert, 1: delete
        loc = int(rng.integers(0, length + 1))
        if ok(loc, loc + action * gap):
            budget -= gap
            (deletes if action else inserts).append((loc, gap))
    events = sorted([(loc, ln, 0) for loc, ln in inserts]
                    + [(loc, ln, 1) for loc, ln in deletes])
    out = []
    pos = 0
    for loc, ln, kind in events:
        out.append(seq[pos:loc])
        if kind == 0:
            out.append(rng.integers(0, 4, ln).astype(seq.dtype))
            pos = loc
        else:
            pos = loc + ln
    out.append(seq[pos:])
    return np.concatenate(out)


def generate_pair(rng, length: int, error: int) -> tuple[str, str, int]:
    """(first copy, second copy, small-mutation share) of one SD pair."""
    seq1 = rng.integers(0, 4, length).astype(np.uint8)
    sed = int(rng.integers(max(0, error - 15), min(15, error) + 1))
    seq2 = make_large(rng, make_small(rng, seq1, sed), error - sed)
    return (LETTERS[seq1].tobytes().decode(),
            LETTERS[seq2].tobytes().decode(), sed)


def make(params: dict, seed: int, stream: int, count: int) -> list[dict]:
    """A pool of ``count`` pairs from (seed, stream): lengths from
    ``count`` strata of [min_len, max_len], error rates cycling over
    [min_error, max_error], both shuffled.  Returns [{"seq1", "seq2",
    "error", "length"}]."""
    rng = np.random.default_rng(entropy(seed, stream))
    lo, hi = params["min_len"], params["max_len"]
    lengths = lo + ((rng.permutation(count) + rng.random(count))
                    * (hi + 1 - lo) / count).astype(np.int64)
    e_lo, e_hi = params["min_error"], params["max_error"]
    errors = e_lo + rng.permutation(np.arange(count) % (e_hi + 1 - e_lo))
    out = []
    for ln, e in zip(lengths.tolist(), errors.tolist()):
        s1, s2, _ = generate_pair(rng, ln, e)
        out.append({"seq1": s1, "seq2": s2, "error": e,
                    "length": len(s1) + len(s2)})
    return out
