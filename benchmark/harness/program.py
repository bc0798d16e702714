"""The program's own trace of a traced window, as the readers take it.

``run.py`` resets and enables the port's spans and counters
(``sedef_tpu_torch/trace.py``) around the window alone and hands the
readers its snapshot as ``ctx["program"]``: every kept span (``name``,
``id``, ``parent``, ``t0``, ``t1`` on ``time.perf_counter()``, ``thread``)
and every registered counter's sums.  The arithmetic below is the
benchmark's own copy of the program's ``totals`` and ``self_totals``, so
that the yardstick does not move with the program.
"""

from __future__ import annotations

from collections import Counter

# the names an idle gap lists at most
NAMES = 4


def _union(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def totals(snap: dict) -> dict[str, float]:
    """Seconds summed over the spans of each name."""
    out: dict[str, float] = {}
    for s in snap["spans"]:
        out[s["name"]] = out.get(s["name"], 0.0) + s["t1"] - s["t0"]
    return out


def self_totals(snap: dict) -> dict[str, float]:
    """Self time summed over the spans of each name: a span's duration less
    the union of its direct children's intervals, each clipped to it."""
    by_id = {s["id"]: s for s in snap["spans"]}
    kids: dict[int, list[tuple[float, float]]] = {}
    for s in snap["spans"]:
        p = by_id.get(s["parent"])
        if p is not None:
            a, b = max(s["t0"], p["t0"]), min(s["t1"], p["t1"])
            if b > a:
                kids.setdefault(p["id"], []).append((a, b))
    out: dict[str, float] = {}
    for sid, s in by_id.items():
        own = s["t1"] - s["t0"] - _union(kids.get(sid, []))
        out[s["name"]] = out.get(s["name"], 0.0) + own
    return out


def ms_per_unit(ctx: dict, name: str, own: bool = False) -> float | None:
    """Milliseconds of the spans named ``name`` (their self time with
    ``own``), summed over every thread, a unit of the window; None where
    the window recorded no such span."""
    snap = ctx.get("program")
    if snap is None or not ctx["n"]:
        return None
    s = (self_totals if own else totals)(snap).get(name)
    return 1e3 * s / ctx["n"] if s is not None else None


def counters(ctx: dict, name: str) -> dict[str, int] | None:
    """The window's sums of the program's counter ``name``."""
    snap = ctx.get("program")
    return None if snap is None else snap["counters"].get(name)


def card_cells_pct(ctx: dict) -> float | None:
    """The card route's share of the gap DPs' cells, in percent; None where
    the window asked for no gap DP."""
    c = counters(ctx, "gapdp")
    if not c:
        return None
    total = c["cells.card"] + c["cells.host"]
    return 100.0 * c["cells.card"] / total if total else None


def open_at(snap: dict, t: float) -> str | None:
    """The innermost program span open at host time ``t`` on each thread
    that has one, as ``name×threads`` by name, the most common first, at
    most ``NAMES`` names and ``+k`` for the ``k`` names left out; None
    where no thread had one open."""
    inner: dict[str, tuple[float, str]] = {}
    for s in snap["spans"]:
        # spans of one thread nest: the innermost started last
        if s["t0"] <= t <= s["t1"] and (
                s["thread"] not in inner or s["t0"] > inner[s["thread"]][0]):
            inner[s["thread"]] = (s["t0"], s["name"])
    if not inner:
        return None
    ranked = sorted(Counter(n for _, n in inner.values()).items(),
                    key=lambda kv: (-kv[1], kv[0]))
    out = ", ".join(f"{n}×{k}" for n, k in ranked[:NAMES])
    if len(ranked) > NAMES:
        out += f", +{len(ranked) - NAMES}"
    return out
