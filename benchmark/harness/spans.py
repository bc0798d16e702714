"""The benchmark's own spans: host-clock intervals around the program's
entry calls, recorded in memory in the traced run only."""

from __future__ import annotations

import functools
import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.rec: dict[str, list[tuple[float, float]]] = defaultdict(list)
        self._undo: list[tuple[object, str, object]] = []

    def wrap(self, fn, name: str):
        rec = self.rec[name]

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                rec.append((t0, time.perf_counter()))
        return spanned

    def install(self, owner, attr: str, name: str) -> bool:
        """Wrap ``owner.attr`` in a span named ``name``; False where the
        program no longer has it (its metric then reads nothing)."""
        fn = getattr(owner, attr, None)
        if fn is None:
            return False
        self._undo.append((owner, attr, fn))
        setattr(owner, attr, self.wrap(fn, name))
        return True

    def restore(self) -> None:
        while self._undo:
            owner, attr, fn = self._undo.pop()
            setattr(owner, attr, fn)

    def seconds(self) -> dict[str, list[float]]:
        return {k: [b - a for a, b in v] for k, v in self.rec.items()}

    def at(self, t: float) -> str | None:
        """The innermost span open at host time ``t`` (the shortest)."""
        best = None
        for name, ivs in self.rec.items():
            for a, b in ivs:
                if a <= t <= b and (best is None or b - a < best[0]):
                    best = (b - a, name)
        return best[1] if best else None
