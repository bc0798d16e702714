"""The gap DPs of the window, kept for the check.

The aligner's ``align_batch`` is the one door through which the program's
alignment paths ask for gap DPs, whichever device then fills them.  The
log wraps it on the driver's aligner and keeps each batch and its answers
under the unit of work (a genome, a pair) being run: references only, no
copy, so the window pays a list append a batch.
"""

from __future__ import annotations

import random

from reference import dp


class GapDPLog:
    def __init__(self, aligner):
        self.unit: list | None = None
        real = aligner.align_batch

        def align_batch(pairs):
            out = real(pairs)
            unit = self.unit
            if unit is not None:
                unit.append((pairs, out))
            return out
        aligner.align_batch = align_batch


def judge(units: list[list], seed: int, count: int, scores: dict
          ) -> tuple[int, int]:
    """(problems judged, problems whose answer is no alignment of its
    inputs or scores below the optimum): ``count`` drawn from the seed
    out of every gap DP of ``units``, and the largest one."""
    probs = [(q, t, c) for unit in units for pairs, out in unit
             for (q, t), c in zip(pairs, out)]
    if not probs:
        return 0, 0
    rng = random.Random(seed)
    pick = set(rng.sample(range(len(probs)), min(count, len(probs))))
    pick.add(max(range(len(probs)),
                 key=lambda i: len(probs[i][0]) * len(probs[i][1])))
    bad = 0
    for i in sorted(pick):
        q, t, c = probs[i]
        d = dp.deficit(q, t, c, scores)
        bad += d is None or d != 0
    return len(pick), bad
