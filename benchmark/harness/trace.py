"""The device trace of a traced run: torch.profiler's CUDA activity
(kernels, copies, sets) over the window, its union as the device's busy
time, the kernels by name, and the idle gaps by what the host was doing.

The union of activity intervals follows ``chip_smoke.py``'s ``_CudaTrace``
(torch.profiler, CUDA activity only), taken as a union of intervals rather
than a sum, so that overlapping streams are counted once.  A marker kernel
(``torch.cuda._sleep``) at each end of the window ties the device's clock
to the host's.
"""

from __future__ import annotations

import functools
import re
import time
from collections import defaultdict

_MARK = "spin_kernel"


def short_name(name: str) -> str:
    """A kernel's function name without namespaces, template arguments and
    parameters; copies and sets keep their whole name."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    head = name.replace("(anonymous namespace)", "").split("(")[0]
    while "<" in head:
        stripped = re.sub(r"<[^<>]*>", "", head)
        if stripped == head:
            break
        head = stripped
    head = head.strip().split(" ")[-1]
    return head.split("::")[-1] or name


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch

    def _mark(self) -> float:
        torch = self.torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
        return t

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.h0 = self._mark()
        return self

    def __exit__(self, *exc):
        self.h1 = self._mark()
        self.prof.__exit__(*exc)
        self._read()

    def _read(self) -> None:
        acts = []
        for ev in self.prof.events():
            tr = ev.time_range
            if getattr(ev, "device_type", None) is None or \
                    "CUDA" not in str(ev.device_type) or tr.end <= tr.start:
                continue
            acts.append((tr.start * 1e-6, tr.end * 1e-6, ev.name))
        marks = sorted(a for a in acts if _MARK in a[2])
        acts = [a for a in acts if _MARK not in a[2]]
        if len(marks) >= 2:
            d0, d1 = marks[0][0], marks[-1][0]
        elif acts:
            d0 = min(a[0] for a in acts)
            d1 = max(a[1] for a in acts)
        else:
            d0, d1 = 0.0, 0.0
        self.offset = d0 - self.h0  # device time = host time + offset
        self.window_s = self.h1 - self.h0
        acts = [(max(a, d0), min(b, d1), n) for a, b, n in acts
                if b > d0 and a < d1]
        acts.sort()
        self.kernels = [(short_name(n), b - a) for a, b, n in acts]
        merged: list[list[float]] = []
        for a, b, _ in acts:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged)
        edges = [d0] + [x for ab in merged for x in ab] + [d0 + self.window_s]
        self.gaps = [(edges[i], edges[i + 1])
                     for i in range(0, len(edges) - 1, 2)
                     if edges[i + 1] > edges[i]]

    def device_ops(self, n: int = 10) -> list[list]:
        per = defaultdict(float)
        for name, s in self.kernels:
            per[name] += s
        return [[k, v] for k, v in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans, n: int = 10) -> list[list]:
        """The ``n`` longest idle gaps, each named by the benchmark span
        open on the host at its middle."""
        out = []
        for a, b in sorted(self.gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (a + b) / 2 - self.offset
            out.append([spans.at(mid) or "outside the program's calls",
                        b - a])
        return out


class GapDPRecord:
    """The shapes of every gap-DP launch group of the window: each
    traceback wrapper of ``ops/wavefront.KERNEL_WRAPPERS`` is wrapped where
    the aligner looks it up (the module's globals), and each group's
    query and target lengths are kept once (a tiled group's tracebacks
    share one length tensor) and read after the window."""

    WRAPPERS = ("backtrack_pack", "tile_backtrack", "tile_backtrack_streamed")

    def __init__(self, wf):
        self.wf = wf
        self.groups: dict[int, tuple] = {}
        self._undo = []

    def install(self) -> None:
        for name in self.WRAPPERS:
            fn = getattr(self.wf, name, None)
            if fn is None:
                continue
            self._undo.append((name, fn))
            setattr(self.wf, name, self._wrap(fn))

    def _wrap(self, fn):
        groups = self.groups

        # the wrapper stands in for the function everywhere, also as the
        # owner of its launch counter (``wrapper.launches``)
        @functools.wraps(fn)
        def recorded(p, ql, tl, *args, **kwargs):
            groups.setdefault(id(ql), (ql, tl))
            return fn(p, ql, tl, *args, **kwargs)
        return recorded

    def restore(self) -> None:
        while self._undo:
            name, fn = self._undo.pop()
            fn.launches = getattr(getattr(self.wf, name), "launches",
                                  getattr(fn, "launches", 0))
            setattr(self.wf, name, fn)

    def lengths(self) -> list[tuple]:
        """[(query lengths, target lengths)] as int64 numpy arrays."""
        return [(ql.cpu().numpy().astype("int64"),
                 tl.cpu().numpy().astype("int64"))
                for ql, tl in self.groups.values()]
