"""The port's spans and counters.

**Spans** time the layers of a request (a pair in ``simulate``, a genome in
``run_pipeline``) on ``time.perf_counter()``, the clock a profiler's device
timeline can be laid against (read a host time ``t`` there as ``t`` plus the
offset between the two clocks' readings of one marker).  They are off
unless :func:`enable` is called: then every span site is one test of a
module-global boolean, and :func:`span` returns one shared no-op object (no
allocation, no clock read).  On, a span records its name, start and end,
its own id, its parent's (the span open on the same thread, or the one a
pool task was handed by :func:`carry`), its root's (the request's
outermost span), its thread and optional small attributes, into a list of
its thread's: no lock on the path.  :func:`snapshot` merges the lists.  At
most ``CAP`` spans are kept between resets; ``trace.dropped`` counts the
rest.

**Counters** (:class:`Counters`) are always on: thread-safe sums under a
lock, added to once per batch of work, never per element.  A named
instance registers itself, and :func:`snapshot` gathers every registered
instance: the seed funnel (``ops/filter.COUNTERS``), the prefilter's
(``ops/prefilter.STATS``), the gap-DP router's (``ops/wavefront.GAPDP``),
the coalescing aligner's rounds (``ops/wavefront.COALESCE``), the region
path's routes, anchors and gaps (``models/aligner.REGION``) and the spans
dropped past the cap (``DROPPED``).

    from sedef_tpu_torch import trace
    trace.reset(); trace.enable()
    ...                                  # the work to look into
    trace.disable()
    snap = trace.snapshot()
    trace.totals(snap)["gapdp.host"]     # seconds in the host's gap DPs
    trace.self_totals(snap)["region"]    # the region path's own Python
"""

from __future__ import annotations

import functools
import itertools
import threading
import time

CAP = 1_000_000

_ON = False


class Counters:
    """Thread-safe named sums over a fixed set of keys.  Dict-like reads
    (``c[key]``, ``dict(c)``, ``iter(c)``); writes go through ``add`` and
    ``update``, each one lock acquisition.  ``name`` registers the
    instance with :func:`snapshot` and :func:`reset` (a later instance of
    the same name takes its place)."""

    def __init__(self, name: str, keys: tuple[str, ...]):
        self.name = name
        self._keys = tuple(keys)
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self._keys, 0)
        _REGISTRY[name] = self

    def add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._c[key] += n

    def update(self, counts: dict[str, int]) -> None:
        """Add every ``counts[key]`` at once."""
        with self._lock:
            for key, n in counts.items():
                self._c[key] += n

    def reset(self) -> None:
        with self._lock:
            for k in self._c:
                self._c[k] = 0

    def __getitem__(self, key: str) -> int:
        with self._lock:
            return self._c[key]

    def keys(self):
        return self._keys

    def __iter__(self):
        return iter(self._keys)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._c)


_REGISTRY: dict[str, Counters] = {}
DROPPED = Counters("trace", ("dropped",))


class _Noop:
    """What :func:`span` returns while tracing is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Thread:
    """One thread's open spans (a stack of (id, root id)) and its kept
    spans."""

    __slots__ = ("stack", "buf", "name")

    def __init__(self):
        self.stack: list[tuple[int, int]] = []
        self.buf: list[tuple] = []
        self.name = threading.current_thread().name
        with _THREADS_LOCK:
            _THREADS.append((threading.current_thread(), self))


_THREADS: list[tuple[threading.Thread, _Thread]] = []
_THREADS_LOCK = threading.Lock()
_LOCAL = threading.local()
_IDS = itertools.count(1)
_KEPT = itertools.count()


def _state() -> _Thread:
    st = getattr(_LOCAL, "st", None)
    if st is None:
        st = _LOCAL.st = _Thread()
    return st


class _Span:
    __slots__ = ("name", "attrs", "id", "root", "parent", "st", "t0")

    def __init__(self, name: str, attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        st = self.st = _state()
        self.parent, root = st.stack[-1] if st.stack else (0, 0)
        self.id = next(_IDS)
        self.root = root or self.id
        st.stack.append((self.id, self.root))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        st = self.st
        st.stack.pop()
        if next(_KEPT) < CAP:
            st.buf.append((self.id, self.parent, self.root, self.name,
                           self.t0, t1, self.attrs))
        else:
            DROPPED.add("dropped")
        return False


def span(name: str, attrs: dict | None = None):
    """A context manager that records ``name`` around its block while
    tracing is on (``attrs``: a few small JSON values), the shared no-op
    while it is off.  Sites pass no per-call ``attrs`` inside a loop over
    anchors, problems or rows."""
    if not _ON:
        return NOOP
    return _Span(name, attrs)


def carry(fn):
    """``fn`` for a pool task (``ThreadPoolExecutor.submit`` / ``map``):
    with tracing on, its spans take the caller's open span as their parent
    and share its root; off (or with no span open), ``fn`` itself."""
    if not _ON:
        return fn
    st = _state()
    if not st.stack:
        return fn
    top = st.stack[-1]

    @functools.wraps(fn)
    def carried(*args, **kwargs):
        mine = _state()
        mine.stack.append(top)
        try:
            return fn(*args, **kwargs)
        finally:
            mine.stack.pop()
    return carried


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def reset() -> None:
    """Drop every kept span (and the lists of threads that have ended)
    and zero every registered counter.  Call it while no span is being
    closed: the spans still open are recorded when they close."""
    global _KEPT
    with _THREADS_LOCK:
        live = []
        for thread, st in _THREADS:
            st.buf.clear()
            if thread.is_alive():
                live.append((thread, st))
        _THREADS[:] = live
    _KEPT = itertools.count()
    for c in list(_REGISTRY.values()):
        c.reset()


def snapshot() -> dict:
    """{"clock": "perf_counter", "spans": [...], "counters": {instance:
    {key: n}}}: every kept span as a dict (``id``, ``parent`` (0: none),
    ``root``, ``name``, ``t0``, ``t1`` in seconds, ``thread``, and
    ``attrs`` where given), ordered by start."""
    with _THREADS_LOCK:
        rows = [(st.name, rec) for _, st in _THREADS for rec in list(st.buf)]
    spans = []
    for thread, (sid, parent, root, name, t0, t1, attrs) in rows:
        s = {"id": sid, "parent": parent, "root": root, "name": name,
             "t0": t0, "t1": t1, "thread": thread}
        if attrs:
            s["attrs"] = dict(attrs)
        spans.append(s)
    spans.sort(key=lambda s: (s["t0"], s["id"]))
    return {"clock": "perf_counter", "spans": spans,
            "counters": {name: c.snapshot()
                         for name, c in sorted(_REGISTRY.items())}}


def _union(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def self_times(snap: dict) -> dict[int, float]:
    """Each span's self time by id: its duration less the union of its
    direct children's intervals (each clipped to the span)."""
    kids: dict[int, list[tuple[float, float]]] = {}
    by_id = {s["id"]: s for s in snap["spans"]}
    for s in snap["spans"]:
        p = by_id.get(s["parent"])
        if p is not None:
            a, b = max(s["t0"], p["t0"]), min(s["t1"], p["t1"])
            if b > a:
                kids.setdefault(p["id"], []).append((a, b))
    return {sid: (s["t1"] - s["t0"]) - _union(kids.get(sid, []))
            for sid, s in by_id.items()}


def totals(snap: dict) -> dict[str, float]:
    """Seconds summed over the spans of each name."""
    out: dict[str, float] = {}
    for s in snap["spans"]:
        out[s["name"]] = out.get(s["name"], 0.0) + s["t1"] - s["t0"]
    return out


def self_totals(snap: dict) -> dict[str, float]:
    """Self time (:func:`self_times`) summed over the spans of each
    name."""
    own = self_times(snap)
    out: dict[str, float] = {}
    for s in snap["spans"]:
        out[s["name"]] = out.get(s["name"], 0.0) + own[s["id"]]
    return out

