"""Counterpart of ``sedef_tpu/models/simulate.py``.

SD simulation harness and aligner API.

Equivalent of the reference Python bindings (``python/sedef.cpp``) and the
simulation-based accuracy harness (``python/simulations.py``): generate
synthetic SD pairs with controlled small-mutation (SNP / 1 bp indel) and
large-indel error, run the engine, classify hit/miss/partial by coverage.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..config import DEFAULT, Config
from ..io.bed import Hit, SeqRef
from ..ops.cigar import Alignment
from ..ops.dna import PackedSeq
from ..ops.index import MinimizerIndex
from ..ops.wavefront import WavefrontAligner
from .aligner import fast_align
from .seeder import HitTree, search

LETTERS = "ACGT"


@dataclass
class SimHit:
    query_start: int
    query_end: int
    ref_start: int
    ref_end: int
    aln: Alignment


def jaccard_align(q: str, r: str, cfg: Config = DEFAULT) -> list[SimHit]:
    """Literal equivalent of PyAligner.jaccard_align (python/sedef.cpp:39-76):
    iterate every HAS_UPPERCASE minimizer with init_len =
    max(len(q), len(r)).  NOTE: with that init_len, ``search`` bails for any
    seed whose window would overrun the query (search.cc:402-404), so hits
    only arise from position-0 seeds when len(q) >= len(r) — reproduced
    as-is for API parity."""
    qh = MinimizerIndex(PackedSeq("qry", q), 12, 16, cfg=cfg)
    rh = MinimizerIndex(PackedSeq("ref", r), 12, 16, cfg=cfg)
    tree = HitTree()
    out = []
    for qi in range(len(qh.keys)):
        if qh.status_of(int(qh.keys[qi])) != 0:
            continue
        hits = search(qi, qh, rh, tree, False, max(len(q), len(r)),
                      True, False, cfg)
        out.extend(SimHit(h.query_start, h.query_end, h.ref_start,
                          h.ref_end, h.aln) for h in hits)
    return out


def seed_align(q: str, r: str, cfg: Config = DEFAULT,
               aligner: WavefrontAligner | None = None) -> list[SimHit]:
    """Production-style seeding between two sequences (initial_search
    semantics with init_len = MIN_READ_SIZE), used by the accuracy
    harness.  Stage 1's device engines, where the seeder's gates let them
    run, run on the device ``run_pipeline`` would give them for
    ``aligner`` (``pipeline.auto_device``): the host for a ``cpu`` one,
    the card where no aligner is given."""
    from .pipeline import auto_device
    from .seeder import initial_search
    qh = MinimizerIndex(PackedSeq("qry", q), cfg.search.kmer_size,
                        cfg.search.window_size, cfg=cfg)
    rh = MinimizerIndex(PackedSeq("ref", r), cfg.search.kmer_size,
                        cfg.search.window_size, cfg=cfg)
    hits = initial_search(qh, rh, False, cfg,
                          use_device=auto_device(aligner) or False)
    return [SimHit(h.query_start, h.query_end, h.ref_start, h.ref_end,
                   h.aln) for h in hits]


def chain_align(q: str, r: str, cfg: Config = DEFAULT,
                aligner: WavefrontAligner | None = None) -> list[SimHit]:
    """PyAligner.chain_align (python/sedef.cpp:78-94)."""
    orig = Hit(SeqRef("A", False, len(q)), 0, len(q),
               SeqRef("B", False, len(r)), 0, len(r))
    hits = fast_align(q, r, orig, 11, cfg, aligner)
    return [SimHit(h.query_start, h.query_end, h.ref_start, h.ref_end,
                   h.aln) for h in hits]


def full_align(q: str, r: str,
               aligner: WavefrontAligner | None = None) -> list[SimHit]:
    """PyAligner.full_align (python/sedef.cpp:96-104)."""
    aln = Alignment.from_seqs(q, r, aligner)
    return [SimHit(0, len(q), 0, len(r), aln)]


# -- SD generator (simulations.py:45-151) -----------------------------------

def rand_seq(rng: random.Random, length: int) -> str:
    return "".join(rng.choice(LETTERS) for _ in range(length))


def make_small(rng: random.Random, seq: str, error: int) -> str:
    """SNP / single-bp indel mutations at ``error`` percent
    (simulations.py:53-75)."""
    out = []
    for ch in seq:
        action = rng.randint(1, 100)
        if action <= error // 3:
            continue  # delete
        if action <= 2 * error // 3:
            out.append(rng.choice(LETTERS))
            out.append(ch)  # insert
        elif action <= error:
            i = LETTERS.find(ch)
            out.append(LETTERS[(i + rng.randint(1, 3)) % 4])  # SNP
        else:
            out.append(ch)
    return "".join(out)


def make_large(rng: random.Random, seq: str, error: int) -> str:
    """Large (>=50 bp) indels totalling ~error percent
    (simulations.py:77-137)."""
    length = len(seq)
    budget = error * length // 100
    inserts: list[tuple[int, int]] = []
    deletes: list[tuple[int, int]] = []

    def ok(start: int, end: int) -> bool:
        if end > length:
            return False
        for s, _ in inserts:
            if start <= s <= end:
                return False
        for s, ln in deletes:
            if start <= s <= end or s <= start <= s + ln:
                return False
        return True

    counter = 0
    while budget > 50 and counter < 10:
        counter += 1
        gap = rng.randint(50, budget)
        action = rng.randint(0, 1)  # 0: insert, 1: delete
        loc = rng.randint(0, length)
        if ok(loc, loc + action * gap):
            budget -= gap
            if action == 0:
                inserts.append((loc, gap))
            else:
                deletes.append((loc, gap))
    events = ([(loc, ln, "I") for loc, ln in inserts]
              + [(loc, ln, "D") for loc, ln in deletes])
    events.sort()
    out = []
    pos = 0
    for loc, ln, kind in events:
        out.append(seq[pos:loc])
        if kind == "I":
            out.append(rand_seq(rng, ln))
            pos = loc
        else:
            pos = loc + ln
    out.append(seq[pos:])
    return "".join(out)


def generate_random_sd(rng: random.Random, error: int,
                       seq: str | None = None,
                       min_len: int = 1000, max_len: int = 100_000
                       ) -> tuple[str, str, int]:
    """simulations.py:139-151"""
    if seq is None:
        seq1 = rand_seq(rng, rng.randint(min_len, max_len))
    else:
        length = rng.randint(min_len, max_len)
        start = rng.randint(0, len(seq) - length - 1)
        seq1 = seq[start:start + length]
    sed = rng.randint(max(0, error - 15), min(15, error))
    seq2 = make_small(rng, seq1, sed)
    seq2 = make_large(rng, seq2, error - sed)
    return seq1, seq2, sed


# -- coverage classification (simulations.py:155-196, 264-313) --------------

def combine(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    if not intervals:
        return []
    sarr = sorted(intervals)
    out = [list(sarr[0])]
    for s, e in sarr[1:]:
        if s <= out[-1][1] + 1:
            out[-1][1] = max(e, out[-1][1])
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def coverage_sum(intervals: list[tuple[int, int]]) -> int:
    return sum(e - s for s, e in combine(intervals))


def classify_pair(seq1: str, seq2: str, error: int,
                  cfg: Config = DEFAULT,
                  aligner: WavefrontAligner | None = None,
                  freeroom: int = 0, seed_fn=None, chain_fn=None) -> str:
    """Jaccard-then-chain detection + coverage classification
    (simulations.py:264-313): 'hit', 'partial' or 'miss'.

    Seeds come from the production seeding path (the binding's
    ``jaccard_align`` init_len makes it fire only from position-0 seeds;
    see its docstring), then seed hits are extended x5/15 Kbp, combined,
    and re-chained.

    ``seed_fn(seq1, seq2)`` / ``chain_fn(sub1, sub2)`` override the two
    engine primitives (objects with query_start/query_end/ref_start/
    ref_end) — the hook the accuracy harness uses to run the REFERENCE
    engine through the identical classification shape
    (tools/accuracy_table.py --ref-oracle)."""
    alen = (len(seq1) + len(seq2)) / 2
    seeds = (seed_fn(seq1, seq2) if seed_fn
             else seed_align(seq1, seq2, cfg, aligner))
    t1 = []
    t2 = []
    for h in seeds:
        w = max(h.query_end - h.query_start, h.ref_end - h.ref_start)
        w = min(15000, int(5 * w))
        t1.append((max(0, h.query_start - w),
                   min(h.query_end + w, len(seq1))))
        t2.append((max(0, h.ref_start - w), min(h.ref_end + w, len(seq2))))
    c1, c2 = combine(t1), combine(t2)
    jc1: list[tuple[int, int]] = []
    jc2: list[tuple[int, int]] = []
    if len(c1) >= 1 and len(c2) >= 1:
        # chain on the combined subranges (first ranges, as the harness
        # only handles the single-interval case; multiple intervals are
        # rare and each is chained here for robustness)
        for (s1, e1), (s2, e2) in zip(c1, c2):
            if chain_fn is not None:
                hits = chain_fn(seq1[s1:e1], seq2[s2:e2])
            else:
                hits = chain_align(seq1[s1:e1], seq2[s2:e2], cfg, aligner)
            jc1.extend((s1 + h.query_start, s1 + h.query_end) for h in hits)
            jc2.extend((s2 + h.ref_start, s2 + h.ref_end) for h in hits)
    jcsum = coverage_sum(jc1) + coverage_sum(jc2)
    if jcsum == 0:
        return "miss"
    if 50.0 * jcsum / alen < 100 - freeroom - error:
        return "partial"
    return "hit"
