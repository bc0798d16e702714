"""Counterpart of ``sedef_tpu/ops/chain.py``.

Sparse weighted anchor chaining.

Equivalent of ``chain_anchors`` (``src/chain.cc:103-199``): sweep anchor
start/end events in query order; each anchor's best predecessor comes from
an argmax-score range query over active anchors' ref end-coordinates within
MAX_CHAIN_GAP, using the corner-gap trick so a static RMQ suffices.

``PrioritySegmentTree`` reimplements the reference's priority-pointer
segment tree (``src/segment.{h,tpp}``) including its activate/deactivate
winner propagation, because tie-breaking among equal chain scores is
determined by that propagation order and affects which chains are emitted.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT, Config
from .anchors import HAS_U, L, Q, R

MIN_SCORE = -(1 << 62)


class PrioritySegmentTree:
    """Static segment tree over sorted keys with activate/deactivate and
    argmax range query; winner pointers propagate like segment.tpp:28-144."""

    __slots__ = ("keys", "scores", "pos", "tree_a", "tree_p", "tree_h",
                 "nsize")

    def __init__(self, entries: list[tuple[tuple, int]]):
        """entries: list of (key, payload); sorted in place by key."""
        entries.sort(key=lambda e: e[0])
        self.keys = [e[0] for e in entries]
        self.pos = [e[1] for e in entries]
        n = len(entries)
        self.scores = [MIN_SCORE] * n
        size = 1
        while size < max(n, 1):
            size <<= 1
        self.tree_a = [-1] * (2 * size)
        self.tree_p = [-1] * (2 * size)
        self.tree_h = [None] * (2 * size)
        self.nsize = len(self.tree_a)
        ti = self._init(0, 0, n, [0])

    def _init(self, i, s, e, counter):
        if i >= self.nsize:
            return
        if s + 1 == e:
            self.tree_a[i] = counter[0]
            self.tree_h[i] = self.keys[counter[0]]
            counter[0] += 1
            return
        bnd = (s + e + 1) // 2
        self._init(2 * i + 1, s, bnd, counter)
        self._init(2 * i + 2, bnd, e, counter)
        src = 2 * i + 1 + (1 if 2 * i + 2 < self.nsize else 0)
        self.tree_h[i] = self.tree_h[src]

    def _find_leaf(self, key):
        leaf = 0
        while leaf < self.nsize and (self.tree_a[leaf] == -1
                                     or key != self.keys[self.tree_a[leaf]]):
            leaf = 2 * leaf + 1 + (1 if key > self.tree_h[2 * leaf + 1] else 0)
        assert leaf < self.nsize and self.tree_a[leaf] != -1
        return leaf

    def activate(self, key, score: int) -> None:
        leaf = self._find_leaf(key)
        self.scores[self.tree_a[leaf]] = score
        i = 0
        while i < self.nsize:
            if (self.tree_p[i] == -1
                    or self.scores[self.tree_a[leaf]]
                    >= self.scores[self.tree_a[self.tree_p[i]]]):
                self.tree_p[i], leaf = leaf, self.tree_p[i]
            if leaf == -1:
                break
            i = 2 * i + 1 + (1 if self.keys[self.tree_a[leaf]]
                             > self.tree_h[2 * i + 1] else 0)

    def deactivate(self, key) -> None:
        leaf = self._find_leaf(key)
        self.scores[self.tree_a[leaf]] = MIN_SCORE
        i = 0
        while i < self.nsize:
            if self.tree_p[i] == -1:
                break
            elif self.tree_p[i] == leaf:
                if self.tree_a[i] != -1:
                    self.tree_p[i] = -1
                    break
                l, r = 2 * i + 1, 2 * i + 2
                if (r < self.nsize and self.tree_p[r] != -1
                        and (self.tree_p[l] == -1
                             or self.scores[self.tree_a[self.tree_p[r]]]
                             > self.scores[self.tree_a[self.tree_p[l]]])):
                    self.tree_p[i] = leaf = self.tree_p[r]
                    i = r
                else:
                    self.tree_p[i] = leaf = self.tree_p[l]
                    i = l
                if leaf == -1:
                    break
            else:
                i = 2 * i + 1 + (1 if key > self.tree_h[2 * i + 1] else 0)

    def _rmq(self, p, q, i):
        if i >= self.nsize:
            return -1
        if self.tree_a[i] != -1:  # leaf
            k = self.keys[self.tree_a[i]]
            return i if p <= k <= q else -1
        pv = self.tree_p[i]
        if pv == -1:
            return -1
        k = self.keys[self.tree_a[pv]]
        if p <= k <= q:
            return pv
        if q <= self.tree_h[2 * i + 1]:
            return self._rmq(p, q, 2 * i + 1)
        if p > self.tree_h[2 * i + 1]:
            return self._rmq(p, q, 2 * i + 2)
        m1 = self._rmq(p, q, 2 * i + 1)
        m2 = self._rmq(p, q, 2 * i + 2)
        if m1 == -1:
            return m2
        if m2 == -1:
            return m1
        return m1 if (self.scores[self.tree_a[m1]]
                      >= self.scores[self.tree_a[m2]]) else m2

    def rmq(self, p, q) -> int:
        """Returns index into the sorted entry arrays, or -1."""
        i = self._rmq(p, q, 0)
        return -1 if i == -1 else self.tree_a[i]


def chain_anchors(anchors: np.ndarray, cfg: Config = DEFAULT,
                  use_native: bool | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """chain.cc:103-199 over ``generate_anchors``' ``(n, 4)`` rows; returns
    (path, boundaries): the anchors' indices chain after chain, and an
    ``(m, 2)`` int64 array of (end in ``path``, has_u) a chain, led by
    (0, 0).  Dispatches to the parity-tested native DP unless disabled
    (SEDEF_NO_NATIVE=1)."""
    n = len(anchors)
    if n == 0:
        return np.empty(0, np.int32), np.zeros((1, 2), np.int64)
    if use_native is None:
        import os
        use_native = os.environ.get("SEDEF_NO_NATIVE", "") == ""
    if use_native:
        try:
            from ..native import lib as _native
        except Exception:  # pragma: no cover
            _native = None
        if _native is not None and _native.has("chain"):
            return _native.chain(
                anchors[:, Q], anchors[:, R], anchors[:, L],
                anchors[:, HAS_U], cfg.chain.max_chain_gap,
                cfg.chain.match_chain_score)
    mcg = cfg.chain.max_chain_gap
    mcs = cfg.chain.match_chain_score
    aq, ar, al, ahu = (anchors[:, c].tolist() for c in (Q, R, L, HAS_U))

    xs = []
    ys_entries = []
    max_q = max_r = 0
    for i in range(n):
        xs.append(((aq[i], i), i))
        xs.append(((aq[i] + al[i], i), i))
        ys_entries.append(((ar[i] + al[i] - 1, i), i))
        max_q = max(max_q, aq[i] + al[i])
        max_r = max(max_r, ar[i] + al[i])
    xs.sort(key=lambda e: e[0])
    tree = PrioritySegmentTree(ys_entries)

    prev = [-1] * n
    dp = [[0, i] for i in range(n)]
    deactivate_bound = 0
    for xi, (coord, i) in enumerate(xs):
        if coord[0] == aq[i]:  # start event
            while deactivate_bound < xi:
                t = xs[deactivate_bound][1]
                tc = xs[deactivate_bound][0][0]
                if tc == aq[t] + al[t]:  # end event
                    if aq[i] - (aq[t] + al[t]) <= mcg:
                        break
                    tree.deactivate((ar[t] + al[t] - 1, t))
                deactivate_bound += 1
            w = mcs * ahu[i] + (mcs // 2) * (al[i] - ahu[i])
            j = tree.rmq((ar[i] - mcg, 0), (ar[i] - 1, n))
            if j != -1 and tree.scores[j] != MIN_SCORE:
                j = tree.pos[j]
                assert aq[i] >= aq[j] + al[j] and ar[i] >= ar[j] + al[j]
                gap = (aq[i] - (aq[j] + al[j])) + (ar[i] - (ar[j] + al[j]))
                if w + dp[j][0] - gap > 0:
                    dp[i][0] = w + dp[j][0] - gap
                    prev[i] = j
                else:
                    dp[i][0] = w
            else:
                dp[i][0] = w
        else:  # end event
            gap = (max_q + 1 - (aq[i] + al[i])) + (max_r + 1 - (ar[i] + al[i]))
            tree.activate((ar[i] + al[i] - 1, i), dp[i][0] - gap)

    dp_sorted = sorted(dp, key=lambda x: (x[0], x[1]), reverse=True)

    path: list[int] = []
    boundaries: list[tuple[int, int]] = [(0, 0)]
    used = [False] * n
    for score, maxi in dp_sorted:
        if used[maxi]:
            continue
        has_u = 0
        while maxi != -1 and not used[maxi]:
            path.append(maxi)
            has_u += ahu[maxi]
            used[maxi] = True
            maxi = prev[maxi]
        boundaries.append((len(path), has_u))
    return (np.array(path, dtype=np.int32),
            np.array(boundaries, dtype=np.int64))
