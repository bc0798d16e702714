"""Counterpart of ``sedef_tpu/ops/wavefront.py``.

Anti-diagonal wavefront affine-gap global aligner on PyTorch + CUDA.

Replacement for the reference's ksw2 ``extz2_sse`` kernel
(``extern/ksw2_extz2_sse.cc``, called from ``src/align.cc:39-68``).  The
reference already uses the rotated (r = i + j) difference-recurrence
formulation with 16-lane int8 SSE; here the same recurrence runs in
hand-written CUDA kernels (``csrc/wavefront_fill.cu``,
``csrc/tile_fill_cluster.cu``; ``fill_plan`` and ``stream_plan`` choose the
organisation of a launch) that write the direction matrix to device memory,
and a second kernel (``csrc/traceback_pack.cu``) walks it back into 2-bit
packed ops, so only one code per anti-diagonal reaches the host.  Each kernel has a plain
PyTorch version beside it (``wavefront_fill_torch``,
``backtrack_pack_torch``): it is the path for tensors on the CPU, and what
the kernels are checked against on the card.  ``wavefront_fill_variant``
runs the direct fill under a family of implementations of the same
recurrence (``csrc/wavefront_fill_variants.cu``), for the variant harness
``tools/kbench.py``.

Recurrence (difference encoding; one row per anti-diagonal r; lane t =
target index i; query index j = r - t):

    z   = s(t, r-t) + 2*(q+e)
    a   = x[r-1][t-1] + v[r-1][t-1]
    b   = y[r-1][t]   + u[r-1][t]
    d   = a > z ? 1 : 0 ;  z = max(z, a)
    d   = b > z ? 2 : d ;  z = max(z, b) ; z = min(z, match + 2*(q+e))
    u[r][t] = z - v[r-1][t-1] ;  v[r][t] = z - u[r-1][t]
    z' = z - q ; a' = a - z' ; b' = b - z'
    x[r][t] = max(a', 0) ; d |= (a' > 0) << 3
    y[r][t] = max(b', 0) ; d |= (b' > 0) << 4

Boundary injections per row r: the shifted lane -1 sees (x1, v1) =
(0, r ? q : 0); lane t == r of the previous state sees (u, y) =
(r ? q : 0, 0).  With a full band these are the only boundary conditions;
out-of-triangle lanes compute garbage that valid cells never read (padding
is the wildcard code 4, scoring 0 against everything, exactly like ksw2's
m-1 wildcard row/column).

CIGAR conventions match the reference mapping ("MDI"[op], align.cc:58-64):
'M' consumes both, 'D' consumes only the query (seq A), 'I' consumes only
the target (seq B).  Gap placement follows ksw2's left-alignment tie-break.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
import threading
from collections.abc import Sequence
from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from ..config import DEFAULT, Config
from ..native import kernels
from .dna import WILDCARD, encode_align

NEG_INF = -(1 << 30)


# ---------------------------------------------------------------------------
# NumPy reference implementation (exact, per-diagonal vectorized)
# ---------------------------------------------------------------------------

def wavefront_np(query: np.ndarray, target: np.ndarray, match: int = 5,
                 mis: int = -4, gapo: int = 40, gape: int = 1
                 ) -> tuple[np.ndarray, int]:
    """Full-band global DP; returns (direction matrix p, score).

    ``query``/``target`` are alignment-alphabet codes (0..3, 4 = wildcard).
    p has shape (qlen + tlen - 1, tlen): one row per anti-diagonal, lane =
    target index.  Scores use int32 (identical values to the int8 SSE kernel
    under its range invariants).
    """
    qlen, tlen = len(query), len(target)
    assert qlen > 0 and tlen > 0
    q, e = gapo, gape
    qe = q + e
    qe2 = 2 * qe
    max_sc = match + qe2
    n_diag = qlen + tlen - 1

    u = np.zeros(tlen, dtype=np.int32)
    v = np.zeros(tlen, dtype=np.int32)
    x = np.zeros(tlen, dtype=np.int32)
    y = np.zeros(tlen, dtype=np.int32)
    H = np.full(tlen, NEG_INF, dtype=np.int64)
    p = np.zeros((n_diag, tlen), dtype=np.uint8)
    score = NEG_INF

    t_idx = np.arange(tlen)
    tq = target.astype(np.int32)

    for r in range(n_diag):
        st0 = max(0, r - qlen + 1)
        en0 = min(r, tlen - 1)
        # query codes per lane: qrow[t] = query[r - t] (wildcard outside)
        j = r - t_idx
        valid_j = (j >= 0) & (j < qlen)
        qrow = np.where(valid_j, query[np.clip(j, 0, qlen - 1)], WILDCARD
                        ).astype(np.int32)
        wild = (qrow >= 4) | (tq >= 4)
        sc = np.where(wild, 0, np.where(qrow == tq, match, mis))

        # boundary injection at lane t == r (previous state)
        if r < tlen:
            u[r] = q if r > 0 else 0
            y[r] = 0
        x1 = 0
        v1 = q if r > 0 else 0
        xs = np.concatenate(([x1], x[:-1]))
        vs = np.concatenate(([v1], v[:-1]))

        z = sc + qe2
        a = xs + vs
        b = y + u
        d = (a > z).astype(np.uint8)
        z = np.maximum(z, a)
        d = np.where(b > z, np.uint8(2), d)
        z = np.maximum(z, b)
        z = np.minimum(z, max_sc)
        u_new = z - vs
        v_new = z - u
        z2 = z - q
        a2 = a - z2
        b2 = b - z2
        x = np.maximum(a2, 0)
        y = np.maximum(b2, 0)
        d |= (a2 > 0).astype(np.uint8) << 3
        d |= (b2 > 0).astype(np.uint8) << 4
        u, v = u_new, v_new
        p[r] = d

        # exact H tracking (ksw2_extz2_sse.cc:222-267) for the final score
        if r == 0:
            H[0] = v[0] - qe - qe
        else:
            if en0 > 0:
                H[en0] = H[en0 - 1] + u[en0] - qe
            else:
                H[en0] = H[en0] + v[en0] - qe
            if st0 < en0:
                H[st0:en0] += v[st0:en0] - qe
        if r == n_diag - 1 and en0 == tlen - 1:
            score = int(H[tlen - 1])
    return p, score


def backtrack_np(p: np.ndarray, qlen: int, tlen: int) -> list[tuple[str, int]]:
    """Host CIGAR backtrack from (tlen-1, qlen-1), ksw2 semantics
    (``extern/ksw2.h:117-151``) with full band (off[r] = st0, off_end[r] =
    en0 computed analytically)."""
    cigar: list[tuple[str, int]] = []

    def push(op: str, ln: int):
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + ln)
        else:
            cigar.append((op, ln))

    i, j = tlen - 1, qlen - 1
    state = 0
    while i >= 0 and j >= 0:
        r = i + j
        st0 = max(0, r - qlen + 1)
        en0 = min(r, tlen - 1)
        force_state = -1
        if i < st0:
            force_state = 2
        if i > en0:
            force_state = 1
        tmp = int(p[r, i]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2)) & 1:
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            push("M", 1)
            i -= 1
            j -= 1
        elif state == 1 or state == 3:
            push("I", 1)  # consumes target (reference op idx 2 -> 'I')
            i -= 1
        else:
            push("D", 1)  # consumes query  (reference op idx 1 -> 'D')
            j -= 1
    if i >= 0:
        push("I", i + 1)
    if j >= 0:
        push("D", j + 1)
    cigar.reverse()
    return cigar


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels (any device; int32 state)
# ---------------------------------------------------------------------------
#
# Streams: B = n_streams * K problems of one (S_q, S_t) class, problem k of
# stream s at index s * K + k, run back to back in the same lanes and
# staggered by S_q rows (K = 1 is the direct fill).  Stream row r, lane t
# belongs to problem (r - t) // S_q at query index (r - t) % S_q; problem
# k's direction rows are stream rows [k * S_q, k * S_q + S_q + S_t - 1).
# A tile is ``tile`` consecutive stream rows; a checkpoint is the state
# (u, y, x, v) entering a tile.  See csrc/wavefront_fill.cu.

def _stream_rows(S_q: int, S_t: int, K: int) -> int:
    return K * S_q + S_t - 1


def _n_tiles(S_q: int, S_t: int, K: int, tile: int) -> int:
    return -(-_stream_rows(S_q, S_t, K) // tile)


def _fill_rows_torch(qseq, tgt, K, r0, r1, state, match, mis, gapo, gape,
                     p_out=None, ckpt=None, tile=0):
    """Stream rows [r0, r1) of the fill, vectorised over (stream, lane).

    ``state``: (n_streams, 4, S_t) int32 u, y, x, v entering row r0.
    Writes row r into ``p_out[:, r - r0]`` and, at every multiple of
    ``tile``, the entering state into ``ckpt[:, r // tile]``."""
    B, S_q = qseq.shape
    S_t = tgt.shape[1]
    n = B // K
    Q = K * S_q
    n_rows = Q + S_t - 1
    dev = tgt.device
    i32 = torch.int32
    qe2 = 2 * (gapo + gape)
    max_sc = match + qe2
    ts = tgt.reshape(n, K * S_t).to(i32)
    # the stream's query codes reversed and wildcard padded, so that row
    # r's per-lane codes q[r - t] are the contiguous slice [n_rows - r, +S_t)
    pad = torch.full((n, S_t - 1), WILDCARD, dtype=i32, device=dev)
    qrev = torch.cat([pad, qseq.reshape(n, Q).to(i32), pad,
                      torch.full((n, 1), WILDCARD, dtype=i32, device=dev)],
                     dim=1).flip(1)
    lane = torch.arange(S_t, device=dev)
    top_bq = (lane > 0).to(i32) * gapo
    u, y, x, v = (state[:, c].clone() for c in range(4))
    zcol = torch.zeros((n, 1), dtype=i32, device=dev)
    for r in range(r0, r1):
        if ckpt is not None and r % tile == 0:
            ckpt[:, r // tile] = torch.stack([u, y, x, v], dim=1)
        m = r - lane
        mc = m.clamp(0, Q - 1)
        k = torch.div(mc, S_q, rounding_mode="floor")
        top = (m >= 0) & (m < Q) & (mc - k * S_q == 0)
        qrow = qrev[:, n_rows - r:n_rows - r + S_t]
        trow = ts.index_select(1, k * S_t + lane)
        sc = (qrow == trow).to(i32) * (match - mis) + mis
        sc = sc.masked_fill((trow >= WILDCARD) | (qrow >= WILDCARD), 0)
        ub = torch.where(top, top_bq, u)
        yb = y.masked_fill(top, 0)
        # lane -1 injection: (x, v) = (0, q) unless lane 0 is at j == 0
        vs0 = gapo if r < Q and r % S_q else 0
        xs = torch.cat([zcol, x[:, :-1]], dim=1)
        vs = torch.cat([zcol + vs0, v[:, :-1]], dim=1)
        z = sc + qe2
        a = xs + vs
        b = yb + ub
        d = (a > z).to(i32)
        z = torch.maximum(z, a)
        d = torch.where(b > z, 2, d)
        z = torch.maximum(z, b).clamp_(max=max_sc)
        z2 = z - gapo
        a2 = a - z2
        b2 = b - z2
        u = z - vs
        v = z - ub
        x = a2.clamp(min=0)
        y = b2.clamp(min=0)
        if p_out is not None:
            d = d | ((a2 > 0).to(i32) << 3) | ((b2 > 0).to(i32) << 4)
            p_out[:, r - r0] = d.to(torch.uint8)


def stream_band(r0: int, r1: int, S_q: int, S_t: int, K: int = 1,
                device=None) -> torch.Tensor:
    """(r1 - r0, S_t) bool: the lanes of stream rows [r0, r1) that the
    kernels write, lane t of row r when 0 <= r - t < K * S_q.  Direction
    bytes, and checkpoint planes of the row before a tile, are defined
    there and only there."""
    r = torch.arange(r0, r1, device=device)[:, None]
    lane = torch.arange(S_t, device=device)[None, :]
    return (lane <= r) & (lane > r - K * S_q)


def _zero_state(n: int, S_t: int, dev) -> torch.Tensor:
    return torch.zeros((n, 4, S_t), dtype=torch.int32, device=dev)


def wavefront_fill_streamed_torch(qseq: torch.Tensor, tgt: torch.Tensor,
                                  K: int, match: int = 5, mis: int = -4,
                                  gapo: int = 40, gape: int = 1
                                  ) -> torch.Tensor:
    """Direction rows of B // K streams of K problems: p (n_streams,
    K * S_q + S_t - 1, S_t) uint8.  qseq: (B, S_q) int8, tgt: (B, S_t)
    int8, both wildcard (4) padded.  On problem k's (ql, tl) triangle,
    rows [k * S_q, k * S_q + ql + tl - 1) equal ``wavefront_np``'s."""
    S_q, S_t = qseq.shape[1], tgt.shape[1]
    n = qseq.shape[0] // K
    n_rows = _stream_rows(S_q, S_t, K)
    p = torch.empty((n, n_rows, S_t), dtype=torch.uint8, device=tgt.device)
    _fill_rows_torch(qseq, tgt, K, 0, n_rows, _zero_state(n, S_t, tgt.device),
                     match, mis, gapo, gape, p_out=p)
    return p


def wavefront_fill_torch(qseq: torch.Tensor, tgt: torch.Tensor,
                         match: int = 5, mis: int = -4, gapo: int = 40,
                         gape: int = 1) -> torch.Tensor:
    """Direction matrix of a batch, p: (B, S_q + S_t - 1, S_t) uint8 in
    ``wavefront_np``'s layout (row = anti-diagonal, lane = target index);
    on each problem's (ql, tl) triangle the bytes equal ``wavefront_np``'s.
    The streamed fill with one problem per stream."""
    return wavefront_fill_streamed_torch(qseq, tgt, 1, match, mis, gapo,
                                         gape)


def tile_checkpoint_torch(qseq: torch.Tensor, tgt: torch.Tensor, tile: int,
                          K: int = 1, match: int = 5, mis: int = -4,
                          gapo: int = 40, gape: int = 1,
                          p_out: torch.Tensor | None = None) -> torch.Tensor:
    """The whole fill, keeping only the state entering each tile:
    (n_streams, n_tiles, 4, S_t) int32 planes u, y, x, v.  With ``p_out``
    (n_streams, K * S_q + S_t - 1, S_t) uint8 the same pass writes the
    direction rows too (``wavefront_fill_streamed_torch``'s)."""
    S_q, S_t = qseq.shape[1], tgt.shape[1]
    n = qseq.shape[0] // K
    ckpt = torch.empty((n, _n_tiles(S_q, S_t, K, tile), 4, S_t),
                       dtype=torch.int32, device=tgt.device)
    _fill_rows_torch(qseq, tgt, K, 0, _stream_rows(S_q, S_t, K),
                     _zero_state(n, S_t, tgt.device), match, mis, gapo, gape,
                     p_out=p_out, ckpt=ckpt, tile=tile)
    return ckpt


def tile_refill_torch(qseq: torch.Tensor, tgt: torch.Tensor,
                      ckpt: torch.Tensor, ti: int, tile: int, K: int = 1,
                      match: int = 5, mis: int = -4, gapo: int = 40,
                      gape: int = 1) -> torch.Tensor:
    """Direction rows of tile ``ti`` recomputed from its checkpoint:
    (n_streams, tile, S_t) uint8, row rr = stream row ti * tile + rr (rows
    past the stream's end are left unwritten)."""
    S_q, S_t = qseq.shape[1], tgt.shape[1]
    n = qseq.shape[0] // K
    r0 = ti * tile
    r1 = min(r0 + tile, _stream_rows(S_q, S_t, K))
    p_tile = torch.empty((n, tile, S_t), dtype=torch.uint8,
                         device=tgt.device)
    _fill_rows_torch(qseq, tgt, K, r0, r1, ckpt[:, ti], match, mis, gapo,
                     gape, p_out=p_tile)
    return p_tile


def _walk_torch(prow_at, ql, tl, i, j, state, r_of, n_diag, rows):
    """Lockstep ksw2 walkers (``backtrack_np``'s state machine) over
    ``rows`` in descending order.  ``prow_at(rr)`` gives the (B, S_t) rows
    each walker reads at step rr, ``r_of(rr)`` each walker's local row.
    Returns (ops (B, len(rows)) int32 with 3 = not consumed, i, j, state)."""
    i32 = torch.int32
    ops = torch.full((ql.shape[0], len(rows)), 3, dtype=i32, device=ql.device)
    for c in range(len(rows) - 1, -1, -1):
        rr = rows[c]
        r = r_of(rr)
        cons = (i >= 0) & (j >= 0) & (i + j == r) & (r < n_diag)
        prow = prow_at(rr)
        ic = i.clamp(0, prow.shape[1] - 1).long().unsqueeze(1)
        tmp = prow.gather(1, ic).squeeze(1).to(i32)
        st0 = (r - ql + 1).clamp(min=0)
        en0 = torch.minimum(tl - 1, r)
        force = (torch.full_like(i, -1).masked_fill_(i > en0, 1)
                 .masked_fill_(i < st0, 2))
        forced = force >= 0
        tmp = tmp.masked_fill(forced, 0)
        bit = ((tmp >> (state + 2)) & 1) > 0
        s1 = torch.where((state != 0) & bit, state, tmp & 7)
        s1 = torch.where(forced, force, s1)
        # op: 0 -> M (i--, j--); 1/3 -> I (i--); 2 -> D (j--)
        op = torch.where(s1 == 2, s1, (s1 != 0).to(i32))
        i = torch.where(cons & (op != 2), i - 1, i)
        j = torch.where(cons & (op != 1), j - 1, j)
        state = torch.where(cons, s1, state)
        ops[:, c] = torch.where(cons, op, 3)
    return ops, i, j, state


def _pack_ops(ops: torch.Tensor) -> torch.Tensor:
    """4 rows per byte, row r at bits 2 * (r % 4); width padded with 3."""
    w = ops.shape[1]
    if w % 4:
        ops = torch.cat([ops, torch.full((ops.shape[0], 4 - w % 4), 3,
                                         dtype=ops.dtype, device=ops.device)],
                        dim=1)
    return (ops[:, 0::4] | (ops[:, 1::4] << 2) | (ops[:, 2::4] << 4)
            | (ops[:, 3::4] << 6)).to(torch.uint8)


def backtrack_pack_torch(p: torch.Tensor, ql: torch.Tensor,
                         tl: torch.Tensor, K: int = 1) -> torch.Tensor:
    """Traceback of every problem of ``p`` (n_streams, K * S_q + S_t - 1,
    S_t), packed 2 bits per anti-diagonal row: 0 = M, 1 = I, 2 = D, 3 =
    row not consumed; row r at byte r // 4, bits 2 * (r % 4).  Returns
    (B, ceil(n_diag / 4)) uint8, B = n_streams * K."""
    _, n_rows, S_t = p.shape
    S_q = (n_rows - S_t + 1) // K
    n_diag = S_q + S_t - 1
    i32 = torch.int32
    ql = ql.to(i32)
    tl = tl.to(i32)
    B = ql.shape[0]
    s = torch.arange(B, device=p.device) // K
    off = (torch.arange(B, device=p.device, dtype=i32) % K) * S_q
    zero = torch.zeros(B, dtype=i32, device=p.device)
    r_hi = int((ql + tl).max()) - 1 if B else 0
    rows = list(range(min(r_hi, n_diag)))
    ops, *_ = _walk_torch(lambda rr: p[s, rr + off], ql, tl, tl - 1, ql - 1,
                          zero, lambda rr: zero + rr, n_diag, rows)
    full = torch.full((B, n_diag), 3, dtype=i32, device=p.device)
    full[:, :len(rows)] = ops
    return _pack_ops(full)


def tile_backtrack_torch(p_tile: torch.Tensor, ql: torch.Tensor,
                         tl: torch.Tensor, ws: torch.Tensor,
                         out: torch.Tensor, r0: int, S_q: int,
                         K: int = 1) -> None:
    """One tile of the tiled traceback, in place: walkers resume from
    ``ws`` (B, 3) int32 (i, j, state), walk the tile's stream rows
    [r0, r0 + tile) downward, and write those rows' packed bytes into
    ``out`` (B, ceil(n_diag / 4)) uint8."""
    _, tile, S_t = p_tile.shape
    n_diag = S_q + S_t - 1
    i32 = torch.int32
    dev = p_tile.device
    B = ql.shape[0]
    s = torch.arange(B, device=dev) // K
    off = (torch.arange(B, device=dev, dtype=i32) % K) * S_q
    ops, i, j, state = _walk_torch(
        lambda rr: p_tile[s, rr], ql.to(i32), tl.to(i32), ws[:, 0], ws[:, 1],
        ws[:, 2], lambda rr: r0 + rr - off, n_diag, list(range(tile)))
    ws.copy_(torch.stack([i, j, state], dim=1))
    packed = _pack_ops(ops)
    for b in range(B):
        o = int(off[b])
        lo, hi = max(0, r0 - o), min(n_diag, r0 + tile - o)
        if lo < hi:
            c = (lo + o - r0) // 4
            out[b, lo // 4:(hi + 3) // 4] = packed[b, c:c + (hi + 3) // 4
                                                   - lo // 4]


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/*.cu), built at first use and bound through ctypes
# (native/kernels.py)
# ---------------------------------------------------------------------------

_VP, _CI = ctypes.c_void_p, ctypes.c_int
# the C signatures of the gap-DP kernels' entry points
_ENTRY_POINTS = {
    "sedef_fill_warp": [_VP] * 3 + [_CI] * 8 + [_VP],
    "sedef_fill_owned": [_VP] * 3 + [_CI] * 8 + [_VP],
    "sedef_fill_cluster": [_VP] * 3 + [_CI] * 14 + [_VP],
    "sedef_fill_streamed": [_VP] * 3 + [_CI] * 14 + [_VP],
    "sedef_tile_ckpt": [_VP] * 3 + [_CI] * 14 + [_VP],
    "sedef_tile_refill": [_VP] * 4 + [_CI] * 15 + [_VP],
    "sedef_tile_cluster_occupancy": [_CI] * 7 + [ctypes.POINTER(_CI)],
    "sedef_walk": [_VP] * 5 + [_CI] * 11 + [_VP],
}


def _entry(name: str):
    return kernels.function(name, _ENTRY_POINTS[name])


def _check_codes(qseq, tgt, K: int) -> torch.device:
    kernels.check(qseq, torch.int8, 2, "qseq")
    kernels.check(tgt, torch.int8, 2, "tgt")
    dev = kernels.same_device(qseq, tgt)
    if qseq.shape[0] != tgt.shape[0]:
        raise ValueError("qseq and tgt must have the same batch size")
    if K < 1 or qseq.shape[0] % K:
        raise ValueError(f"batch of {qseq.shape[0]} is not a whole number "
                         f"of {K}-problem streams")
    if qseq.shape[1] < 1 or tgt.shape[1] < 1:
        raise ValueError("empty size class")
    return dev


def _check_tile(tile: int) -> None:
    if tile < 4 or tile % 4:
        raise ValueError("tile must be a positive multiple of 4 rows")


def _threads(B: int, width: int) -> int:
    """The block of the variant ``base``, whose threads stride over a
    row's band (at most ``width`` lanes): few problems get wide blocks,
    many problems narrower ones so that several blocks share an SM."""
    width = -(-width // 32) * 32
    return min(1024 if B < 264 else 256, width)


def wavefront_fill(qseq: torch.Tensor, tgt: torch.Tensor, match: int = 5,
                   mis: int = -4, gapo: int = 40, gape: int = 1, *,
                   plan: "FillPlan | None" = None) -> torch.Tensor:
    """Direction matrix (B, S_q + S_t - 1, S_t) uint8 of a batch.

    On a CUDA tensor this launches one hand-written kernel on the current
    stream (no synchronisation) or raises: under ``plan`` or the card's
    ``fill_plan_on``, the warp fill or the owned-lane fill of
    ``csrc/wavefront_fill.cu``, or the cluster fill of
    ``csrc/tile_fill_cluster.cu`` run from the zero state.  On a CPU tensor
    it is ``wavefront_fill_torch``.  The kernels write only each row's band
    lanes (``stream_band``); the rest of ``p`` is undefined."""
    dev = _check_codes(qseq, tgt, 1)
    if dev.type == "cpu":
        return wavefront_fill_torch(qseq, tgt, match, mis, gapo, gape)
    B, S_q = qseq.shape
    S_t = tgt.shape[1]
    p = torch.empty((B, S_q + S_t - 1, S_t), dtype=torch.uint8, device=dev)
    if B == 0:
        return p
    plan = plan or fill_plan_on(dev, S_q, S_t, B)
    codes = (qseq.data_ptr(), tgt.data_ptr(), p.data_ptr())
    score = (match, mis, gapo, gape)
    if plan.org == "warp":
        kernels.launch(wavefront_fill, dev, _entry("sedef_fill_warp"),
                       *codes, B, S_q, S_t, *score, plan.per_block)
    elif plan.org == "owned":
        kernels.launch(wavefront_fill, dev, _entry("sedef_fill_owned"),
                       *codes, B, S_q, S_t, *score, plan.N)
    else:
        kernels.launch(wavefront_fill, dev, _entry("sedef_fill_cluster"),
                       *codes, B, 1, S_q, S_t, *score, 0, *plan.tile)
    return p


# the direct fill's variants (csrc/wavefront_fill_variants.cu), by
# organisation: shared-memory state with striding threads (base); owned
# lanes with the state in shared memory (hoist, unrollN; packed: pack,
# packuN; unroll2 with the cell's max-and-test pairs as one __vibmax_s32
# each: vibmax); owned lanes with the state in registers (reg, regN; packed:
# preg, pregN; without boundary selects past the ramp: bspec, bspecN); the
# two-lanes-a-word cell of csrc/dp_cell2.cuh with owned lanes (dpx2, dpx2u4)
# and in registers (dpx2reg); the register row over a cluster of C blocks
# (cluC, and with the word cell dpx2cluC)
FILL_VARIANTS = ("base", "hoist", "unroll2", "unroll4", "pack", "packu2",
                 "packu4", "reg", "reg2", "reg4", "preg", "preg2", "preg4",
                 "bspec", "bspec2", "bspec4", "vibmax", "dpx2", "dpx2u4",
                 "dpx2reg", "clu2", "clu4", "dpx2clu2", "dpx2clu4")
# lanes a thread owns in every variant but base, and the widest class of a
# block
VARIANT_LANES = 4
VARIANT_MAX_S_T = 1024 * VARIANT_LANES
# blocks a problem of the cluster variants; their classes are whole groups
# of VARIANT_CLUSTER_GROUP lanes a block
VARIANT_CLUSTER = {"clu2": 2, "clu4": 4, "dpx2clu2": 2, "dpx2clu4": 4}
VARIANT_CLUSTER_GROUP = 8
# the two-lanes-a-word cell holds every in-band value in an int16 (u, v in
# [0, max_sc], a and b up to max_sc + gapo) and reads the match and
# mismatch scores from an int8 table
DPX2_LIMIT = 1 << 15


def dpx2_scoring_fits(match: int, mis: int, gapo: int, gape: int) -> bool:
    """Whether the two-lanes-a-word variants take the scoring (the rule of
    ``score2_fits`` in ``csrc/dp_cell2.cuh``)."""
    max_sc = match + 2 * (gapo + gape)
    return (gapo >= 0 and gape >= 0 and -128 <= match <= 127
            and -128 <= mis <= 127 and max_sc >= 0
            and max_sc + gapo < DPX2_LIMIT)


def check_variant_shape(variant: str, S_t: int, match: int, mis: int,
                        gapo: int, gape: int) -> None:
    """``ValueError`` for a class or scoring ``variant`` does not take."""
    if variant == "base":
        return
    C = VARIANT_CLUSTER.get(variant, 1)
    unit = VARIANT_CLUSTER_GROUP * C if C > 1 else VARIANT_LANES
    if S_t % unit or S_t > VARIANT_MAX_S_T * C:
        raise ValueError(f"variant {variant!r} takes S_t a multiple of "
                         f"{unit} up to {VARIANT_MAX_S_T * C}, got {S_t}")
    if (variant.startswith(("pack", "preg"))
            and match + 2 * (gapo + gape) > 127):
        raise ValueError(f"variant {variant!r} packs v + 128 and x into 8 "
                         f"bits each: match + 2 * (gapo + gape) must be at "
                         f"most 127")
    if (variant.startswith("dpx2")
            and not dpx2_scoring_fits(match, mis, gapo, gape)):
        raise ValueError(f"variant {variant!r} holds two lanes a word: "
                         f"match + 2 * (gapo + gape) + gapo must be below "
                         f"{DPX2_LIMIT} and match, mis in [-128, 127]")


def pack_state_torch(x: torch.Tensor, v: torch.Tensor, q: torch.Tensor
                     ) -> torch.Tensor:
    """The packed variants' state word (int32): x in bits 0-7, v + 128 in
    bits 8-15, the query code in bits 16-19.  In the band 0 <= x <= gapo
    and 0 <= v <= match + 2 * (gapo + gape) <= 127, so eight bits each
    are enough."""
    i32 = torch.int32
    return (q.to(i32) << 16) | ((v.to(i32) + 128) << 8) | x.to(i32)


def unpack_state_torch(word: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, v, q) of a packed state word, as the kernels read them."""
    return word & 0xFF, ((word >> 8) & 0xFF) - 128, word >> 16


# the variant kernel's entry points (csrc/wavefront_fill_variants.cu)
_VARIANT_ENTRY_POINTS = {
    "sedef_fill_variant": [ctypes.c_char_p] + [_VP] * 3 + [_CI] * 8 + [_VP],
    "sedef_fill_variant_clusters": ([ctypes.c_char_p] + [_CI] * 2
                                    + [ctypes.POINTER(_CI)]),
}


def _variant_entry(name: str):
    """The variant kernel's entry point ``name``, once the library is
    known to be built with the variants of ``FILL_VARIANTS``."""
    _check_built_variants()
    return kernels.function(name, _VARIANT_ENTRY_POINTS[name])


@functools.cache
def _check_built_variants() -> None:
    name_of = kernels.function("sedef_fill_variant_name", [_CI],
                               ctypes.c_char_p)
    names = (name_of(i) for i in range(len(FILL_VARIANTS) + 1))
    built = tuple(n.decode() for n in names if n is not None)
    if built != FILL_VARIANTS:
        raise RuntimeError(f"kernel library's fill variants {built} are not "
                           f"FILL_VARIANTS {FILL_VARIANTS}")


def wavefront_fill_variant(variant: str, qseq: torch.Tensor,
                           tgt: torch.Tensor, match: int = 5, mis: int = -4,
                           gapo: int = 40, gape: int = 1) -> torch.Tensor:
    """``wavefront_fill`` under the implementation ``variant`` (a name in
    ``FILL_VARIANTS``): the same (B, S_q + S_t - 1, S_t) uint8 direction
    bytes on every lane of a row's band.

    On a CUDA tensor this launches ``csrc/wavefront_fill_variants.cu`` on
    the current stream (no synchronisation) or raises; on a CPU tensor it
    is ``wavefront_fill_torch``, the plain version of every variant.  An
    unknown name, or a class or scoring a variant does not take, raises
    ``ValueError`` on either device; a cluster variant whose cluster the
    card cannot hold (``fill_variant_clusters`` 0) raises ``RuntimeError``
    and launches nothing."""
    if variant not in FILL_VARIANTS:
        raise ValueError(f"unknown fill variant {variant!r}; one of "
                         f"{', '.join(FILL_VARIANTS)}")
    dev = _check_codes(qseq, tgt, 1)
    B, S_q = qseq.shape
    S_t = tgt.shape[1]
    check_variant_shape(variant, S_t, match, mis, gapo, gape)
    if dev.type == "cpu":
        return wavefront_fill_torch(qseq, tgt, match, mis, gapo, gape)
    p = torch.empty((B, S_q + S_t - 1, S_t), dtype=torch.uint8, device=dev)
    if B:
        kernels.launch(wavefront_fill_variant, dev,
                       _variant_entry("sedef_fill_variant"),
                       variant.encode(), qseq.data_ptr(), tgt.data_ptr(),
                       p.data_ptr(), B, S_q, S_t, match, mis, gapo, gape,
                       _threads(B, min(S_q, S_t)))
    return p


def fill_variant_clusters(variant: str, S_q: int, S_t: int,
                          dev: torch.device) -> int:
    """Clusters of the cluster variant ``variant`` (or one-block chains of
    ``dpx2reg``) at class (S_q, S_t) that the card ``dev`` holds at once
    (``cudaOccupancyMaxActiveClusters``); 0: a launch would be refused."""
    if variant not in VARIANT_CLUSTER and variant != "dpx2reg":
        raise ValueError(f"{variant!r} is no chain of warps")
    check_variant_shape(variant, S_t, 5, -4, 40, 1)
    out = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = _variant_entry("sedef_fill_variant_clusters")(
            variant.encode(), S_q, S_t, ctypes.byref(out))
    if rc:
        raise RuntimeError(f"cluster occupancy query failed: CUDA error "
                           f"{rc}")
    return out.value


def wavefront_fill_streamed(qseq: torch.Tensor, tgt: torch.Tensor, K: int,
                            match: int = 5, mis: int = -4, gapo: int = 40,
                            gape: int = 1, *,
                            plan: "StreamPlan | None" = None
                            ) -> torch.Tensor:
    """Direction rows (B // K, K * S_q + S_t - 1, S_t) uint8 of B // K
    streams of K problems (problem k of stream s at batch index s * K + k).

    On a CUDA tensor this launches one hand-written kernel on the current
    stream (no synchronisation) or raises, under ``plan`` or the card's
    ``stream_plan_on``: "parallel", every problem at once under the direct
    fill's owned-lane kernel (``csrc/fill_owned.cuh``) or cluster fill
    (``csrc/tile_fill_cluster.cu``), written into its stream's rows; or,
    forced, "chain", the cluster fill over each stream's K problems in
    turn.  On a
    CPU tensor it is ``wavefront_fill_streamed_torch``.  The kernels write
    only each row's band lanes (``stream_band``); the rest of ``p`` is
    undefined."""
    dev = _check_codes(qseq, tgt, K)
    if dev.type == "cpu":
        return wavefront_fill_streamed_torch(qseq, tgt, K, match, mis, gapo,
                                             gape)
    B, S_q = qseq.shape
    S_t = tgt.shape[1]
    n = B // K
    p = torch.empty((n, _stream_rows(S_q, S_t, K), S_t), dtype=torch.uint8,
                    device=dev)
    if n == 0:
        return p
    plan = plan or stream_plan_on(dev, S_q, S_t, n, K)
    f = plan.fill
    kernels.launch(wavefront_fill_streamed, dev,
                   _entry("sedef_fill_streamed"), qseq.data_ptr(),
                   tgt.data_ptr(), p.data_ptr(), n, K, S_q, S_t, match, mis,
                   gapo, gape, _STREAM_KERNELS[plan.org, f.org], f.C, f.W,
                   f.lanes, f.N, f.ring)
    return p


# The cluster tile fill (csrc/tile_fill_cluster.cu): one stream's S_t lanes
# go over the C blocks of a thread-block cluster, W lanes a block, 1, 2 or
# 4 lanes a thread; block c runs N rows behind block c - 1 and the cluster
# barrier comes once per N rows.
TILE_LANES = (1, 2, 4)   # lanes a thread can own
TILE_THREADS = 1024      # threads of one block at most
TILE_MAX_W = TILE_THREADS * TILE_LANES[-1]  # lanes of one block at most
TILE_MIN_W = 256         # below this a block's row is too short to split
# a thread owns two lanes from this block width on: at W = 512 .. 1024 the
# checkpoint pass is 7-13% faster with two lanes a thread than with one, at
# W = 256 and 384 no faster (tools/kbench.py's tiled table on an H100)
TILE_TWO_LANES_W = 512
TILE_MAX_CLUSTER = 16    # the card's largest (non-portable) cluster
# rows per cluster barrier: at 10 and 60 Kbp the checkpoint pass is ~10%
# faster with 32 than with 8 and a 4096-row refill no slower, its longer
# ramp included (tools/kbench.py's tiled table on an H100)
TILE_ROWS_PER_BARRIER = 32


class TilePlan(NamedTuple):
    """How the cluster tile fill lays out one stream: ``C`` blocks of
    ``W`` lanes (a multiple of 4, C * W >= S_t), ``lanes`` consecutive
    lanes a thread, a cluster barrier every ``N`` rows, seam rings of
    ``ring`` slots."""
    C: int
    W: int
    lanes: int
    N: int
    ring: int

    @property
    def smem_bytes(self) -> int:
        """A block's shared memory: u, y and two parity planes of x and v
        for its lanes, and the two inbound seam rings."""
        return 4 * (6 * self.W + 2 * self.ring)


def tile_min_cluster(S_t: int) -> int:
    """The smallest cluster (a power of two) whose blocks hold S_t lanes."""
    C = 1
    while -(-S_t // C) > TILE_MAX_W:
        C *= 2
    if C > TILE_MAX_CLUSTER:
        raise ValueError(f"S_t = {S_t} exceeds the cluster tile fill's "
                         f"{TILE_MAX_CLUSTER * TILE_MAX_W} lanes")
    return C


def tile_plan(S_t: int, n_streams: int, sms: int,
              N: int = TILE_ROWS_PER_BARRIER, C: int | None = None,
              lanes: int | None = None) -> TilePlan:
    """The plan of a launch of ``n_streams`` streams S_t lanes wide on a
    card of ``sms`` SMs.  C, unless given: the largest power of two up to
    TILE_MAX_CLUSTER that leaves a block at least TILE_MIN_W lanes and
    asks for no more blocks than the card has SMs, but never fewer blocks
    than S_t lanes need (clusters beyond the SM count queue whole).
    ``lanes``, unless given: the fewest lanes a thread that a block of
    TILE_THREADS threads covers W with, and two from TILE_TWO_LANES_W lanes
    on (a short row is bound by one warp's chain of instructions, so it
    wants many warps of few lanes; a long one by the SM's instruction rate,
    so it wants few instructions a cell).  The seam ring is the power of
    two above the 2 N + 1 rows that are live at a seam during a step."""
    if S_t < 1 or n_streams < 1 or sms < 1:
        raise ValueError("S_t, n_streams and sms must be positive")
    if N < 1 or (N > 1 and N % 2):
        raise ValueError(f"rows per barrier must be 1 or even, got {N}")
    need = tile_min_cluster(S_t)
    if C is None:
        C = 1
        while (2 * C <= TILE_MAX_CLUSTER and -(-S_t // (2 * C)) >= TILE_MIN_W
               and n_streams * 2 * C <= sms):
            C *= 2
        C = max(C, need)
    elif C < need or C & (C - 1):
        raise ValueError(f"a cluster of {C} blocks cannot hold S_t = {S_t} "
                         f"(a power of two >= {need})")
    W = -(-(-(-S_t // C)) // 4) * 4
    if lanes is None:
        lanes = next(n for n in TILE_LANES if W <= TILE_THREADS * n)
        if lanes == 1 and W >= TILE_TWO_LANES_W:
            lanes = 2
    elif lanes not in TILE_LANES or W > TILE_THREADS * lanes:
        raise ValueError(f"{lanes} lanes a thread cannot cover {W} lanes "
                         f"with {TILE_THREADS} threads")
    ring = 4
    while ring <= 2 * N:
        ring *= 2
    return TilePlan(C, W, lanes, N, ring)


_OCCUPANCY: dict = {}


def tile_cluster_occupancy(plan: TilePlan, n_streams: int, mode: int,
                           dev: torch.device) -> int:
    """Clusters of ``plan``'s shape the card holds at once
    (``cudaOccupancyMaxActiveClusters``); 0 when the card refuses the
    shape.  ``mode`` picks the kernel: 0 (False) the checkpoint pass, 1
    (True) the refill, 2 the direct fill (and a chain of a stream's
    problems), 3 one of a stream's problems filled beside the others."""
    key = (dev.index, plan, int(mode))
    if key not in _OCCUPANCY:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = _entry("sedef_tile_cluster_occupancy")(
                int(mode), n_streams, *plan, ctypes.byref(out))
        _OCCUPANCY[key] = 0 if rc else out.value
    return _OCCUPANCY[key]


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def tile_plan_on(dev: torch.device, S_t: int, n_streams: int, refill: bool
                 ) -> TilePlan:
    """``tile_plan`` for the card ``dev``: its SM count, and C halved while
    the card cannot hold the launch's clusters all at once (a cluster
    lives inside one GPC, so fewer fit than SMs / C; a cluster that
    queues doubles the launch's time), never below what S_t needs.  A
    launch the card still refuses raises."""
    sms = _sm_count(dev)
    plan = tile_plan(S_t, n_streams, sms)
    while (plan.C > tile_min_cluster(S_t)
           and tile_cluster_occupancy(plan, n_streams, refill, dev)
           < n_streams):
        plan = tile_plan(S_t, n_streams, sms, C=plan.C // 2)
    return plan


# The direct fill's organisations.  "warp": one warp per problem, four
# lanes a thread, state in registers, several problems a block
# (csrc/wavefront_fill.cu; classes of at most FILL_WARP_LANES lanes).
# "owned": one block per problem, four owned lanes a thread, state in
# shared memory, FILL_OWNED_UNROLL rows an unrolled step
# (csrc/fill_owned.cuh, the variant harness's unroll4; S_t a multiple of 4
# up to FILL_OWNED_MAX_W).
# "cluster": the cluster fill of csrc/tile_fill_cluster.cu run from the zero
# state over the whole matrix, a problem's lanes over a cluster of C blocks
# (C = 1: one block, for the classes "owned" does not take).
FILL_ORGS = ("warp", "owned", "cluster")
FILL_WARP_LANES = 128
# problems a block: against eight, four are 20% faster on 32 problems and
# 2% slower on 4,096 (tools/kbench.py's direct-fill table on an H100)
FILL_WARP_PER_BLOCK = 4
FILL_SMEM_BYTES = 227 * 1024  # a block's shared memory at most
FILL_OWNED_LANES = 4
FILL_OWNED_MAX_W = 1024 * FILL_OWNED_LANES
# rows an unrolled step, of (2, 4): four is 3-8% faster than two at
# (1024,1024) from 64 to 1,056 problems (tools/kbench.py on an H100)
FILL_OWNED_UNROLL = 4
# up to this width one block of owned lanes beats a cluster at every batch
# size: its row costs 0.23 us per 1,024 lanes, a cluster's block 0.35-0.48 us
# at any width (tools/kbench.py's direct-fill table on an H100)
FILL_OWNED_WIDEST = 2048


class FillPlan(NamedTuple):
    """How one launch of the direct fill is laid over the card: the
    organisation ``org`` (one of FILL_ORGS), then ``TilePlan``'s fields
    (for "warp" and "owned" one block of 4-lane threads and no ring; N is
    the rows of an unrolled step) and the problems a block ``per_block`` (1
    unless "warp")."""
    org: str
    C: int
    W: int
    lanes: int
    N: int
    ring: int
    per_block: int

    @property
    def tile(self) -> TilePlan:
        """The cluster fill's plan of a "cluster" launch."""
        return TilePlan(self.C, self.W, self.lanes, self.N, self.ring)


def _owned_takes(S_q: int, S_t: int) -> bool:
    """Whether the owned-lane kernel takes the class: whole 4-lane groups,
    1,024 threads, and six int32 planes and the query in shared memory."""
    return (S_t % FILL_OWNED_LANES == 0 and S_t <= FILL_OWNED_MAX_W
            and 24 * S_t + S_q <= FILL_SMEM_BYTES)


def fill_plan(S_q: int, S_t: int, B: int, sms: int, *,
              org: str | None = None, C: int | None = None,
              lanes: int | None = None, N: int | None = None,
              per_block: int | None = None) -> FillPlan:
    """The plan of a direct fill of ``B`` problems of class (S_q, S_t) on a
    card of ``sms`` SMs.

    Classes of at most FILL_WARP_LANES lanes take a warp per problem,
    FILL_WARP_PER_BLOCK problems a block (fewer when a block's shared
    memory does not hold that many queries).  Wider classes take one block
    of owned lanes per problem up to FILL_OWNED_WIDEST lanes, and beyond
    that when the batch leaves a problem one block anyway.  What remains,
    few problems of a wide class, takes the cluster fill under
    ``tile_plan``: C the largest power of two with B * C blocks on no more
    than ``sms`` SMs and at least TILE_MIN_W lanes a block, and no more
    lanes a thread than a problem has query codes.  ``org``, ``C``,
    ``lanes``, ``N`` and ``per_block`` force a choice; what the kernels do
    not take raises ``ValueError``."""
    if min(S_q, S_t, B, sms) < 1:
        raise ValueError("S_q, S_t, B and sms must be positive")
    if org is not None and org not in FILL_ORGS:
        raise ValueError(f"unknown organisation {org!r}; one of "
                         f"{', '.join(FILL_ORGS)}")
    free = C is None and lanes is None and N is None
    if org is None and free and (S_t <= FILL_WARP_LANES
                                 and S_q <= FILL_SMEM_BYTES):
        org = "warp"
    if org == "warp":
        if S_t > FILL_WARP_LANES or S_q > FILL_SMEM_BYTES:
            raise ValueError(f"a warp holds {FILL_WARP_LANES} lanes and a "
                             f"block {FILL_SMEM_BYTES} query codes, got "
                             f"class ({S_q}, {S_t})")
        if C not in (None, 1) or lanes not in (None, 4) or N is not None:
            raise ValueError("the warp fill is one block of 4-lane threads "
                             "without a barrier")
        if per_block is None:
            per_block = max(1, min(FILL_WARP_PER_BLOCK,
                                   FILL_SMEM_BYTES // S_q))
        elif not (1 <= per_block <= 32
                  and per_block * S_q <= FILL_SMEM_BYTES):
            raise ValueError(f"{per_block} problems a block: 1 to 32, and "
                             f"their query codes in shared memory")
        return FillPlan("warp", 1, FILL_WARP_LANES, 4, 0, 0, per_block)
    if per_block not in (None, 1):
        raise ValueError("only the warp fill shares a block among problems")
    if org == "owned":
        if not _owned_takes(S_q, S_t):
            raise ValueError(f"owned lanes take S_t a multiple of "
                             f"{FILL_OWNED_LANES} up to {FILL_OWNED_MAX_W} "
                             f"and 24 * S_t + S_q bytes of shared memory, "
                             f"got class ({S_q}, {S_t})")
        if (C not in (None, 1) or lanes not in (None, FILL_OWNED_LANES)
                or N not in (None, 2, 4)):
            raise ValueError("owned lanes are one block a problem, four "
                             "lanes a thread, two or four rows a step")
        return FillPlan("owned", 1, S_t, FILL_OWNED_LANES,
                        N or FILL_OWNED_UNROLL, 0, 1)
    tp = tile_plan(S_t, B, sms, N=N or TILE_ROWS_PER_BARRIER, C=C,
                   lanes=lanes)
    if (org is None and free and _owned_takes(S_q, S_t)
            and (tp.C == 1 or S_t <= FILL_OWNED_WIDEST)):
        return fill_plan(S_q, S_t, B, sms, org="owned")
    if tp.lanes > S_q:
        # a thread's lanes reach their top rows one after the other, so it
        # owns no more lanes than the query has codes; more blocks make up
        # for the narrower threads
        cap = max(n for n in TILE_LANES if n <= S_q)
        while lanes is not None or tp.W > TILE_THREADS * cap:
            if (lanes is not None or C is not None
                    or tp.C >= TILE_MAX_CLUSTER):
                raise ValueError(f"S_q = {S_q} allows {cap} lanes a thread, "
                                 f"which cannot cover {tp.W} lanes a block")
            tp = tile_plan(S_t, B, sms, N=tp.N, C=2 * tp.C)
        tp = tp._replace(lanes=min(tp.lanes, cap))
    return FillPlan("cluster", *tp, 1)


@functools.lru_cache(maxsize=4096)
def fill_plan_on(dev: torch.device, S_q: int, S_t: int, B: int) -> FillPlan:
    """``fill_plan`` for the card ``dev``: its SM count, and C halved while
    the card cannot hold the launch's clusters all at once (as
    ``tile_plan_on``).  Remembered per shape: a launch group's plan costs
    the wrapper nothing the second time."""
    sms = _sm_count(dev)
    plan = fill_plan(S_q, S_t, B, sms)
    least = fill_plan(S_q, S_t, B, 1).C  # what the class itself needs
    while (plan.C > least
           and tile_cluster_occupancy(plan.tile, B, 2, dev) < B):
        plan = fill_plan(S_q, S_t, B, sms, C=plan.C // 2)
    return plan


# The streamed fill's organisations.  "parallel": each of the n_streams * K
# problems under the kernel ``fill_plan`` gives a direct fill of them all
# (one block of owned lanes, or a cluster), all at once, each written at
# stream row k * S_q of its stream and storing only its own band bytes.
# "chain": the cluster fill with one stream a cluster, its K problems one
# after the other in the cluster's lanes (the TPU kernel's order of work).
# The plan takes "parallel"; "chain" is only ever forced.
STREAM_ORGS = ("parallel", "chain")
# sedef_fill_streamed's ``org`` argument, by (organisation, kernel)
_STREAM_KERNELS = {("parallel", "owned"): 0, ("parallel", "cluster"): 1,
                   ("chain", "cluster"): 2}


class StreamPlan(NamedTuple):
    """How one launch of the streamed fill is laid over the card: the
    organisation ``org`` (one of STREAM_ORGS) and the plan ``fill`` of its
    kernel: for "parallel" that of one problem in a direct fill of all
    n_streams * K ("owned" or "cluster"), for "chain" the cluster fill's
    plan of one stream a cluster."""
    org: str
    fill: FillPlan


def stream_plan(S_q: int, S_t: int, n_streams: int, K: int, sms: int, *,
                org: str | None = None, kernel: str | None = None,
                C: int | None = None, lanes: int | None = None,
                N: int | None = None) -> StreamPlan:
    """The plan of a streamed fill of ``n_streams`` streams of ``K``
    problems of class (S_q, S_t) on a card of ``sms`` SMs.

    "parallel" unless ``org`` forces "chain".  "parallel" takes
    ``fill_plan(S_q, S_t, n_streams * K, sms)``'s kernel, and where that
    is the warp fill (S_t <= 128, a layout no streamed class has) owned
    lanes, or the cluster fill for an S_t owned lanes do not take.
    "chain" takes the cluster fill under ``fill_plan(S_q, S_t, n_streams,
    sms, org="cluster")``.  ``org``, ``kernel`` ("owned" or "cluster"),
    ``C``, ``lanes`` and ``N`` force a choice (any of the last four
    "parallel" unless ``org`` says otherwise); what the kernels do not
    take raises ``ValueError``."""
    if min(S_q, S_t, n_streams, K, sms) < 1:
        raise ValueError("S_q, S_t, n_streams, K and sms must be positive")
    org = org or "parallel"
    if org not in STREAM_ORGS:
        raise ValueError(f"unknown organisation {org!r}; one of "
                         f"{', '.join(STREAM_ORGS)}")
    if kernel not in (None, "owned", "cluster"):
        raise ValueError(f"the streamed fill launches owned lanes or the "
                         f"cluster fill, not {kernel!r}")
    force = dict(C=C, lanes=lanes, N=N)
    if org == "chain":
        if kernel == "owned":
            raise ValueError("a chain runs on the cluster fill")
        return StreamPlan(org, fill_plan(S_q, S_t, n_streams, sms,
                                         org="cluster", **force))
    fp = fill_plan(S_q, S_t, n_streams * K, sms, org=kernel, **force)
    if fp.org == "warp":
        fp = fill_plan(S_q, S_t, n_streams * K, sms,
                       org="owned" if _owned_takes(S_q, S_t) else "cluster")
    return StreamPlan(org, fp)


@functools.lru_cache(maxsize=4096)
def stream_plan_on(dev: torch.device, S_q: int, S_t: int, n_streams: int,
                   K: int) -> StreamPlan:
    """``stream_plan`` for the card ``dev`` ("parallel"): its SM count,
    and C halved while the card cannot hold the launch's clusters all at
    once (as ``fill_plan_on``).  Remembered per shape."""
    sms = _sm_count(dev)
    plan = stream_plan(S_q, S_t, n_streams, K, sms)
    if plan.fill.org != "cluster":
        return plan
    n = n_streams * K
    least = stream_plan(S_q, S_t, n_streams, K, 1, kernel="cluster").fill.C
    while (plan.fill.C > least
           and tile_cluster_occupancy(plan.fill.tile, n, 3, dev) < n):
        plan = stream_plan(S_q, S_t, n_streams, K, sms, kernel="cluster",
                           C=plan.fill.C // 2)
    return plan


def _check_tile_class(S_q: int) -> None:
    if S_q < TILE_LANES[-1]:
        raise ValueError(f"the cluster tile fill takes S_q >= "
                         f"{TILE_LANES[-1]}")


def _tile_ckpt(wrapper, qseq, tgt, K, tile, score, plan=None):
    dev = _check_codes(qseq, tgt, K)
    _check_tile(tile)
    if dev.type == "cpu":
        return tile_checkpoint_torch(qseq, tgt, tile, K, *score)
    B, S_q = qseq.shape
    S_t = tgt.shape[1]
    n = B // K
    _check_tile_class(S_q)
    ckpt = torch.empty((n, _n_tiles(S_q, S_t, K, tile), 4, S_t),
                       dtype=torch.int32, device=dev)
    if n:
        plan = plan or tile_plan_on(dev, S_t, n, False)
        kernels.launch(wrapper, dev, _entry("sedef_tile_ckpt"),
                       qseq.data_ptr(), tgt.data_ptr(), ckpt.data_ptr(), n,
                       K, S_q, S_t, tile, *score, *plan)
    return ckpt


def tile_checkpoint(qseq: torch.Tensor, tgt: torch.Tensor, tile: int,
                    match: int = 5, mis: int = -4, gapo: int = 40,
                    gape: int = 1, *, plan: TilePlan | None = None
                    ) -> torch.Tensor:
    """Checkpoint pass of the tiled route: the state entering each
    ``tile``-row tile, (B, n_tiles, 4, S_t) int32 (u, y, x, v), defined on
    the lanes of the band of the row before the tile.  Launches the
    cluster tile fill ``csrc/tile_fill_cluster.cu`` on a CUDA tensor (or
    raises), under ``plan`` or the card's ``tile_plan_on``;
    ``tile_checkpoint_torch`` on a CPU tensor."""
    return _tile_ckpt(tile_checkpoint, qseq, tgt, 1, tile,
                      (match, mis, gapo, gape), plan)


def tile_checkpoint_streamed(qseq: torch.Tensor, tgt: torch.Tensor, K: int,
                             tile: int, match: int = 5, mis: int = -4,
                             gapo: int = 40, gape: int = 1, *,
                             plan: TilePlan | None = None) -> torch.Tensor:
    """``tile_checkpoint`` over B // K streams of K problems:
    (B // K, n_tiles, 4, S_t) int32; the same kernel, K problems chained
    in a cluster's lanes."""
    return _tile_ckpt(tile_checkpoint_streamed, qseq, tgt, K, tile,
                      (match, mis, gapo, gape), plan)


def _tile_refill(wrapper, qseq, tgt, ckpt, ti, K, tile, score, plan=None):
    dev = _check_codes(qseq, tgt, K)
    _check_tile(tile)
    kernels.check(ckpt, torch.int32, 4, "ckpt")
    kernels.same_device(qseq, ckpt)
    B, S_q = qseq.shape
    S_t = tgt.shape[1]
    n = B // K
    n_tiles = _n_tiles(S_q, S_t, K, tile)
    if tuple(ckpt.shape) != (n, n_tiles, 4, S_t) or not 0 <= ti < n_tiles:
        raise ValueError(f"checkpoint {tuple(ckpt.shape)} / tile {ti} do "
                         f"not match {n} streams of {n_tiles} tiles")
    if dev.type == "cpu":
        return tile_refill_torch(qseq, tgt, ckpt, ti, tile, K, *score)
    _check_tile_class(S_q)
    p_tile = torch.empty((n, tile, S_t), dtype=torch.uint8, device=dev)
    if n:
        plan = plan or tile_plan_on(dev, S_t, n, True)
        kernels.launch(wrapper, dev, _entry("sedef_tile_refill"),
                       qseq.data_ptr(), tgt.data_ptr(), ckpt.data_ptr(),
                       p_tile.data_ptr(), n, K, S_q, S_t, tile, ti, *score,
                       *plan)
    return p_tile


def tile_refill(qseq: torch.Tensor, tgt: torch.Tensor, ckpt: torch.Tensor,
                ti: int, tile: int, match: int = 5, mis: int = -4,
                gapo: int = 40, gape: int = 1, *,
                plan: TilePlan | None = None) -> torch.Tensor:
    """Direction rows of tile ``ti`` recomputed from ``tile_checkpoint``'s
    output: (B, tile, S_t) uint8, defined on each row's band lanes.
    Launches the cluster tile fill ``csrc/tile_fill_cluster.cu`` on a CUDA
    tensor (or raises), under ``plan`` or the card's ``tile_plan_on``;
    ``tile_refill_torch`` on a CPU tensor."""
    return _tile_refill(tile_refill, qseq, tgt, ckpt, ti, 1, tile,
                        (match, mis, gapo, gape), plan)


def tile_refill_streamed(qseq: torch.Tensor, tgt: torch.Tensor,
                         ckpt: torch.Tensor, ti: int, K: int, tile: int,
                         match: int = 5, mis: int = -4, gapo: int = 40,
                         gape: int = 1, *, plan: TilePlan | None = None
                         ) -> torch.Tensor:
    """``tile_refill`` over B // K streams of K problems; the same
    kernel."""
    return _tile_refill(tile_refill_streamed, qseq, tgt, ckpt, ti, K, tile,
                        (match, mis, gapo, gape), plan)


# The walker of csrc/traceback_pack.cu: a warp per walker on patches of R
# direction rows that the warp copies into shared memory at once, the patch
# below fetched while the one at hand is walked.
WALK_ROWS = (32, 64)     # patch heights the kernel is built for
WALK_ALIGN = 16          # a patch row starts on a 16-lane boundary
WALK_WARPS = 4           # walkers a block once they outnumber the SMs
WALK_SMS = 132           # an H100's SMs, where the caller names no card


class WalkPlan(NamedTuple):
    """How the tracebacks walk: patches of ``R`` rows (0: one thread per
    walker, one global read per consumed row; the yardstick) of ``pw``
    bytes a row, the patch below fetched ahead when ``prefetch``,
    ``warps`` walkers a block."""
    R: int
    pw: int
    prefetch: bool
    warps: int

    @property
    def smem_bytes(self) -> int:
        """A block's shared memory: two patches a walker."""
        return self.warps * 2 * self.R * self.pw


def walk_plan(B: int, sms: int = WALK_SMS, *, R: int = WALK_ROWS[-1],
              prefetch: bool = True, pw: int | None = None,
              warps: int | None = None) -> WalkPlan:
    """The plan of a traceback launch of ``B`` walkers.  A walker lowers
    its lane by at most one per consumed row, so a patch R + WALK_ALIGN
    bytes wide holds R rows of any walk from its top row; with
    2 R + WALK_ALIGN the patch fetched ahead holds the walker wherever the
    patch before lets it arrive, which is what ``prefetch`` takes unless
    ``pw`` says otherwise (a narrower guess that the walker leaves is
    fetched again).  One walker a block while they are fewer than the
    SMs' twofold, WALK_WARPS then."""
    if B < 1 or sms < 1:
        raise ValueError("B and sms must be positive")
    if R == 0:
        return WalkPlan(0, 0, False, 0)
    if R not in WALK_ROWS:
        raise ValueError(f"patches are {WALK_ROWS} rows high, got {R}")
    if pw is None:
        pw = (2 * R if prefetch else R) + WALK_ALIGN
    if pw % WALK_ALIGN or not R + WALK_ALIGN <= pw <= 2 * R + WALK_ALIGN:
        raise ValueError(f"a patch row is a multiple of {WALK_ALIGN} bytes "
                         f"in [{R + WALK_ALIGN}, {2 * R + WALK_ALIGN}], got "
                         f"{pw}")
    if warps is None:
        warps = 1 if B <= 2 * sms else WALK_WARPS
    plan = WalkPlan(R, pw, bool(prefetch), warps)
    if not 1 <= warps <= 32 or plan.smem_bytes > FILL_SMEM_BYTES:
        raise ValueError(f"{warps} walkers a block: 1 to 32, and their "
                         f"patches in shared memory")
    return plan


@functools.lru_cache(maxsize=4096)
def _walk_plan_on(dev: torch.device, B: int) -> WalkPlan:
    return walk_plan(B, _sm_count(dev))


def _check_walk(p, ql, tl, B: int) -> torch.device:
    kernels.check(p, torch.uint8, 3, "p")
    kernels.check(ql, torch.int32, 1, "ql")
    kernels.check(tl, torch.int32, 1, "tl")
    if ql.shape[0] != B or tl.shape[0] != B:
        raise ValueError("ql/tl must have one entry per problem")
    return kernels.same_device(p, ql, tl)


def _walk(wrapper, dev, p, ql, tl, ws, out, K, S_q, r0, plan) -> None:
    """Launch the walker over stream rows [r0, r0 + p.shape[1]) of ``p``
    for ``wrapper``, under ``plan`` or the card's."""
    _, tile, S_t = p.shape
    B = ql.shape[0]
    if plan is None:
        plan = _walk_plan_on(dev, B)
    kernels.launch(wrapper, dev, _entry("sedef_walk"), p.data_ptr(),
                   ql.data_ptr(), tl.data_ptr(), kernels.ptr(ws),
                   out.data_ptr(), B, K, S_q, S_t, out.shape[1], r0, tile,
                   plan.R, plan.pw, int(plan.prefetch), plan.warps)


def backtrack_pack(p: torch.Tensor, ql: torch.Tensor, tl: torch.Tensor,
                   K: int = 1, *, plan: WalkPlan | None = None
                   ) -> torch.Tensor:
    """Packed traceback ops (B, ceil(n_diag / 4)) uint8 of ``p``, the
    output of ``wavefront_fill`` (K = 1) or ``wavefront_fill_streamed``.

    ``ql``/``tl``: (B,) int32 true lengths, 1 <= ql <= S_q and
    1 <= tl <= S_t (the caller's contract; the kernel never reads outside
    a problem's slab).  On a CUDA tensor this launches the walker of
    ``csrc/traceback_pack.cu`` on the current stream, under ``plan`` or
    the card's ``walk_plan``, or raises; on a CPU tensor it is
    ``backtrack_pack_torch``."""
    n, n_rows, S_t = p.shape
    B = n * K
    dev = _check_walk(p, ql, tl, B)
    if K < 1 or (n_rows - S_t + 1) % K or n_rows - S_t + 1 < K:
        raise ValueError(f"{n_rows} rows are not {K}-problem streams")
    if dev.type == "cpu":
        return backtrack_pack_torch(p, ql, tl, K)
    S_q = (n_rows - S_t + 1) // K
    n_bytes = (S_q + S_t - 1 + 3) // 4
    out = torch.empty((B, n_bytes), dtype=torch.uint8, device=dev)
    if B:
        # the whole matrix is one tile from stream row 0, walked from each
        # problem's corner (no saved walkers)
        _walk(backtrack_pack, dev, p, ql, tl, None, out, K, S_q, 0, plan)
    return out


def _tile_backtrack(wrapper, p_tile, ql, tl, ws, out, r0, S_q, K, plan):
    n, tile, S_t = p_tile.shape
    B = n * K
    dev = _check_walk(p_tile, ql, tl, B)
    _check_tile(tile)
    kernels.check(ws, torch.int32, 2, "ws")
    kernels.check(out, torch.uint8, 2, "out")
    kernels.same_device(p_tile, ws, out)
    n_bytes = (S_q + S_t - 1 + 3) // 4
    if tuple(ws.shape) != (B, 3) or tuple(out.shape) != (B, n_bytes):
        raise ValueError("ws must be (B, 3) and out (B, ceil(n_diag / 4))")
    if r0 % tile:
        raise ValueError("r0 must be the first row of a tile")
    if dev.type == "cpu":
        return tile_backtrack_torch(p_tile, ql, tl, ws, out, r0, S_q, K)
    if B:
        _walk(wrapper, dev, p_tile, ql, tl, ws, out, K, S_q, r0, plan)


def tile_backtrack(p_tile: torch.Tensor, ql: torch.Tensor, tl: torch.Tensor,
                   ws: torch.Tensor, out: torch.Tensor, r0: int, S_q: int,
                   *, plan: WalkPlan | None = None) -> None:
    """One tile of the tiled traceback, in place: the walkers in ``ws``
    (B, 3) int32 (i, j, state) walk ``p_tile`` (``tile_refill``'s output
    for the tile starting at row r0) and write its rows' packed bytes into
    ``out`` (B, ceil(n_diag / 4)) uint8.  Launches the warp-per-walker
    window kernel of ``csrc/traceback_pack.cu`` on a CUDA tensor, under
    ``plan`` or the card's ``walk_plan`` (or raises);
    ``tile_backtrack_torch`` on a CPU tensor."""
    _tile_backtrack(tile_backtrack, p_tile, ql, tl, ws, out, r0, S_q, 1,
                    plan)


def tile_backtrack_streamed(p_tile: torch.Tensor, ql: torch.Tensor,
                            tl: torch.Tensor, ws: torch.Tensor,
                            out: torch.Tensor, r0: int, S_q: int, K: int,
                            *, plan: WalkPlan | None = None) -> None:
    """``tile_backtrack`` over streams of K problems (B = n_streams * K
    walkers, problem k reading stream rows from k * S_q); the same
    kernel."""
    _tile_backtrack(tile_backtrack_streamed, p_tile, ql, tl, ws, out, r0,
                    S_q, K, plan)


# every kernel wrapper, in the order of the reference package's kernels
KERNEL_WRAPPERS = (wavefront_fill, backtrack_pack, wavefront_fill_streamed,
                   tile_checkpoint, tile_refill, tile_backtrack,
                   tile_checkpoint_streamed, tile_refill_streamed,
                   tile_backtrack_streamed, wavefront_fill_variant)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


# ---------------------------------------------------------------------------
# High-level batched API
# ---------------------------------------------------------------------------

def cigar_from_packed_ops(packed_row: np.ndarray, qlen: int, tlen: int
                          ) -> list[tuple[str, int]]:
    """Decode one problem's 2-bit op stream into a CIGAR."""
    return cigars_from_packed(np.asarray(packed_row)[None], [qlen],
                              [tlen])[0]


def _offsets(counts: np.ndarray) -> np.ndarray:
    """(n + 1,) int64: where each of n runs of ``counts`` items starts in
    their concatenation, and the total last."""
    out = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=out[1:])
    return out


def _span_index(ln: np.ndarray, first: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """Spans of lengths ``ln`` concatenated (``first`` is
    ``_offsets(ln)``): each item's span and its place inside the span."""
    row = np.repeat(np.arange(len(ln)), ln)
    return row, np.arange(first[-1]) - first[:-1][row]


class GapBatch(Sequence):
    """A batch of gap DPs as flat arrays: problem i is the code views
    ``(q[qo[i]:qo[i] + ql[i]], t[to[i]:to[i] + tl[i]])``.  ``len``,
    indexing and iteration give those ``(q, t)`` pairs, as a list of
    pairs does; ``WavefrontAligner.align_batch`` takes either form and
    reads this one without a step per problem."""

    __slots__ = ("q", "t", "qo", "ql", "to", "tl")

    def __init__(self, q: np.ndarray, t: np.ndarray, qo, ql, to, tl):
        self.q, self.t = q, t
        self.qo, self.ql, self.to, self.tl = (
            np.asarray(a, np.int64) for a in (qo, ql, to, tl))

    @classmethod
    def of(cls, pairs) -> "GapBatch":
        """A list of (query, target) code arrays as one batch: one
        concatenation a side."""
        if isinstance(pairs, GapBatch):
            return pairs
        qs = [np.asarray(q) for q, _ in pairs]
        ts = [np.asarray(t) for _, t in pairs]
        ql = np.fromiter(map(len, qs), np.int64, len(qs))
        tl = np.fromiter(map(len, ts), np.int64, len(ts))
        empty = np.zeros(0, np.uint8)
        return cls(np.concatenate(qs) if qs else empty,
                   np.concatenate(ts) if ts else empty,
                   _offsets(ql)[:-1], ql, _offsets(tl)[:-1], tl)

    @classmethod
    def join(cls, batches) -> "GapBatch":
        """One batch of ``batches``' problems in order (each a batch or a
        list of pairs), over their problems' codes alone, concatenated."""
        bs = [cls.of(b) for b in batches]
        sides = []
        for side in (0, 1):
            codes = [b.codes(np.arange(len(b)), side) for b in bs]
            shift = _offsets([len(c) for c, _ in codes])
            sides.append((np.concatenate([c for c, _ in codes]),
                          np.concatenate([f[:-1] + s for (_, f), s
                                          in zip(codes, shift)])))
        (q, qo), (t, to) = sides
        return cls(q, t, qo, np.concatenate([b.ql for b in bs]), to,
                   np.concatenate([b.tl for b in bs]))

    def __len__(self) -> int:
        return len(self.ql)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return GapBatch(self.q, self.t, self.qo[i], self.ql[i],
                            self.to[i], self.tl[i])
        qo, ql = int(self.qo[i]), int(self.ql[i])
        to, tl = int(self.to[i]), int(self.tl[i])
        return self.q[qo:qo + ql], self.t[to:to + tl]

    def __iter__(self):
        q, t = self.q, self.t
        for qo, ql, to, tl in zip(self.qo.tolist(), self.ql.tolist(),
                                  self.to.tolist(), self.tl.tolist()):
            yield q[qo:qo + ql], t[to:to + tl]

    def _side(self, side: int):
        return ((self.q, self.qo, self.ql) if side == 0
                else (self.t, self.to, self.tl))

    def codes(self, idx: np.ndarray, side: int
              ) -> tuple[np.ndarray, np.ndarray]:
        """Problems ``idx``' codes of one side (0 query, 1 target)
        concatenated as uint8, and where each starts (``_offsets`` of
        their lengths)."""
        codes, off, ln = self._side(side)
        first = _offsets(ln[idx])
        row, pos = _span_index(ln[idx], first)
        return codes.take(off[idx][row] + pos).astype(np.uint8), first

    def pad(self, idx: np.ndarray, side: int, B: int, S: int) -> np.ndarray:
        """(B, S) int8: row b the codes of one side of problem idx[b],
        wildcard padded, rows past len(idx) all wildcard: a gather of
        S-code windows of the codes (of a wildcard-padded copy of their
        end where a window runs past it), then the padding."""
        codes, off, ln = self._side(side)
        o, n = off[idx], len(codes)
        if n < S or o.max() > n - S:
            lo = min(int(o.min()), max(n - S, 0))
            codes = np.concatenate([codes[lo:].astype(np.int8, copy=False),
                                    np.full(S, WILDCARD, np.int8)])
            o, n = o - lo, len(codes)
        codes = np.ascontiguousarray(codes)
        step = codes.itemsize
        out = np.full((B, S), WILDCARD, np.int8)
        rows = out[:len(idx)]
        # row i of the view: the S codes from i on
        rows[:] = np.ndarray((n - S + 1, S), codes.dtype, codes,
                             strides=(step, step))[o]
        rows[np.arange(S, dtype=np.int32)
             >= ln[idx].astype(np.int32)[:, None]] = WILDCARD
        return out


# the ASCII codes of the walker's moves 0 M, 1 I, 2 D
_OP_ASCII = np.frombuffer(b"MID", np.uint8)
# a byte's four 2-bit codes, low bits first
_UNPACK = (np.arange(256, dtype=np.uint8)[:, None]
           >> np.array([0, 2, 4, 6], np.uint8)) & 3


class CigarBatch(Sequence):
    """The CIGARs of a batch of gap DPs as three arrays: the runs' ops
    (ASCII ``M``, ``I``, ``D``, uint8) and lengths (int32), and where
    each problem's runs start (``first``, n + 1 int64, ``first[0]`` 0).
    ``len``, indexing and iteration give each problem's CIGAR as the list
    of ``(op, length)`` tuples ``align_batch`` has always returned, built
    when read; a slice is the batch of those problems, and a batch equals
    the list of its CIGARs."""

    __slots__ = ("ops", "lens", "first")

    def __init__(self, ops: np.ndarray, lens: np.ndarray, first: np.ndarray):
        self.ops, self.lens, self.first = ops, lens, first

    @classmethod
    def scatter(cls, n: int, parts) -> "CigarBatch":
        """The batch of n problems from ``parts``, (problem indices, their
        ``CigarBatch``) pairs that cover the n problems once: one scatter
        a part (none where one part holds the n in order)."""
        if len(parts) == 1 and np.array_equal(parts[0][0], np.arange(n)):
            return parts[0][1]
        cnt = np.zeros(n, np.int64)
        for idx, c in parts:
            cnt[idx] = np.diff(c.first)
        first = _offsets(cnt)
        ops = np.empty(first[-1], np.uint8)
        lens = np.empty(first[-1], np.int32)
        for idx, c in parts:
            row, pos = _span_index(np.diff(c.first), c.first)
            at = first[:-1][idx][row] + pos
            ops[at] = c.ops
            lens[at] = c.lens
        return cls(ops, lens, first)

    def __len__(self) -> int:
        return len(self.first) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            a, b, step = i.indices(len(self))
            if step != 1:
                return [self[k] for k in range(a, b, step)]
            b = max(a, b)
            lo, hi = int(self.first[a]), int(self.first[b])
            return CigarBatch(self.ops[lo:hi], self.lens[lo:hi],
                              self.first[a:b + 1] - lo)
        i = range(len(self))[i]
        lo, hi = int(self.first[i]), int(self.first[i + 1])
        return list(zip(self.ops[lo:hi].tobytes().decode("ascii"),
                        self.lens[lo:hi].tolist()))

    def __iter__(self):
        ops = self.ops.tobytes().decode("ascii")
        lens = self.lens.tolist()
        first = self.first.tolist()
        for lo, hi in zip(first, first[1:]):
            yield list(zip(ops[lo:hi], lens[lo:hi]))

    def __eq__(self, other):
        if isinstance(other, CigarBatch):
            return (np.array_equal(self.first, other.first)
                    and np.array_equal(self.ops, other.ops)
                    and np.array_equal(self.lens, other.lens))
        if isinstance(other, list):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        return NotImplemented

    def __add__(self, other):
        return list(self) + list(other)

    def __radd__(self, other):
        return list(other) + list(self)

    def __repr__(self) -> str:
        return f"CigarBatch({list(self)!r})"


def cigar_runs(cigars) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(runs a problem, ops, lengths) of a batch's CIGARs as arrays: a
    ``CigarBatch``'s own, or a list of CIGARs flattened."""
    if isinstance(cigars, CigarBatch):
        return np.diff(cigars.first), cigars.ops, cigars.lens
    cnt = np.fromiter(map(len, cigars), np.int64, len(cigars))
    flat = list(itertools.chain.from_iterable(cigars))
    if not flat:
        return cnt, np.zeros(0, np.uint8), np.zeros(0, np.int32)
    ops, lens = zip(*flat)
    return (cnt, np.frombuffer("".join(ops).encode("ascii"), np.uint8),
            np.array(lens, np.int32))


def cigars_from_packed(ops: np.ndarray, ql, tl) -> CigarBatch:
    """Decode a launch group's packed ops (B, ceil(n_diag / 4)) uint8 and
    its (B,) lengths into the ``CigarBatch`` of its B CIGARs, in one pass
    of array operations.

    Code r of a row (byte r / 4, bits 2 * (r % 4)) is the walker's move on
    anti-diagonal r: 0 M, 1 I, 2 D, 3 none; codes at r >= ql + tl - 1 are
    never read.  The walker leaves ``ql - nM - nD`` D and ``tl - nM - nI``
    I on an edge (each when positive), which start the alignment in that
    order: ``backtrack_np``'s residual handling.  Adds the runs emitted to
    the ``gapdp`` counter ``decode.runs``."""
    ops = np.asarray(ops, np.uint8)
    B, n_bytes = ops.shape
    ql = np.asarray(ql, np.int64)
    tl = np.asarray(tl, np.int64)
    W = 4 * n_bytes
    codes = _UNPACK.take(ops, axis=0).reshape(B, W)
    keep = codes != 3
    keep &= (np.arange(W, dtype=np.int32)
             < (ql + tl - 1).astype(np.int32)[:, None])
    at = np.flatnonzero(keep)
    vals = codes.ravel().take(at)
    # the moves' runs: a run starts where the op or the row changes (each
    # row's first move in ``at``; a row without moves has the next's)
    row_at = np.searchsorted(at, np.arange(B) * W)
    start = np.empty(len(at), bool)
    start[:1] = True
    np.not_equal(vals[1:], vals[:-1], out=start[1:])
    start[row_at[row_at < len(at)]] = True
    run = np.flatnonzero(start)
    rop = vals[run]
    rlen = np.diff(run, append=len(at))
    rrow = np.searchsorted(row_at, run, "right") - 1
    # each row: its D residual, its I residual, its moves' runs; then the
    # empty runs out and the runs of one op in a row merged
    n = np.bincount(rrow * 3 + rop, weights=rlen, minlength=3 * B
                    ).reshape(B, 3).astype(np.int64)
    per_row = np.bincount(rrow, minlength=B) + 2
    at_row = _offsets(per_row)[:-1]
    aop = np.empty(len(run) + 2 * B, np.uint8)
    alen = np.empty(len(aop), np.int64)
    aop[at_row], aop[at_row + 1] = 2, 1
    alen[at_row] = np.maximum(ql - n[:, 0] - n[:, 2], 0)
    alen[at_row + 1] = np.maximum(tl - n[:, 0] - n[:, 1], 0)
    moves = np.arange(len(run)) + 2 * (rrow + 1)
    aop[moves], alen[moves] = rop, rlen
    live = np.flatnonzero(alen)
    arow = np.repeat(np.arange(B), per_row)[live]
    aop, alen = aop[live], alen[live]
    start = np.ones(len(aop), bool)
    start[1:] = (aop[1:] != aop[:-1]) | (arow[1:] != arow[:-1])
    first = np.flatnonzero(start)
    GAPDP.add("decode.runs", len(first))
    return CigarBatch(_OP_ASCII[aop[first]],
                      np.add.reduceat(alen, first).astype(np.int32),
                      np.searchsorted(arow[first], np.arange(B + 1)))


SIZE_CLASSES = (128, 256, 512, 1024, 2048)
# the launch groups' routes
ROUTES = ("direct", "streamed", "tiled", "streamed-tiled")


def _route(K: int, tile: int | None) -> str:
    """A launch group's route: streamed when K > 1, tiled with a tile."""
    return ROUTES[(K > 1) + 2 * (tile is not None)]


# the gap-DP router's counts, each added once an ``align_batch`` call:
# problems and cells (ql x tl, as ``device_cells`` counts them, without
# the padding problems of whole streams) by route, launch groups by
# route, and the problems of calls given a ``GapBatch``; and the CIGAR
# runs ``cigars_from_packed`` emitted, added once a call
GAPDP = trace.Counters("gapdp", (
    "problems.degenerate", "problems.host", "problems.card", "cells.host",
    "cells.card", *(f"groups.{r}" for r in ROUTES), "flat.problems",
    "decode.runs"))
# rounds the coalescing aligners dispatched
COALESCE = trace.Counters("coalesce", ("rounds",))
# the aligner's uncalibrated batch floors (problems, DP cells)
FROZEN_BATCH_MIN = 8
FROZEN_BATCH_MIN_CELLS = 1 << 21


_CLASSES = np.array(SIZE_CLASSES)


def _pad_to_class(n):
    """The size class of a length ``n`` (an int, or each of an int
    array): the smallest of SIZE_CLASSES that holds it, past the largest
    a multiple of 2048."""
    n = np.asarray(n, np.int64)
    top = _CLASSES[-1]
    out = np.where(n <= top,
                   _CLASSES[np.searchsorted(_CLASSES, np.minimum(n, top))],
                   (n + 2047) // 2048 * 2048)
    return out if out.ndim else int(out)


def _as_device(device) -> torch.device:
    """The aligner's explicit device: ``cuda`` (the kernels) or ``cpu``
    (the plain PyTorch versions).  ``cuda`` without a card raises; there
    is no silent switch to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("WavefrontAligner(device='cuda'): no CUDA "
                               "device is available (ask for device='cpu' "
                               "explicitly to run the plain PyTorch path)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"WavefrontAligner(device='{dev}'): the "
                               f"host has {torch.cuda.device_count()} CUDA "
                               f"device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class WavefrontAligner:
    """Batched global aligner: CUDA fill + traceback kernels on ``cuda``,
    their plain PyTorch versions on ``cpu``, the native scalar DP for
    stragglers on either."""

    def __init__(self, cfg: Config = DEFAULT, device="cuda"):
        self.cfg = cfg
        self.match = cfg.align.match
        self.mis = cfg.align.mismatch          # negative
        self.gapo = -cfg.align.gap_open        # positive 40
        self.gape = -cfg.align.gap_extend      # positive 1
        self.device = _as_device(device)
        # one device batch at a time: bounds device memory to one launch's
        # direction matrix when region threads call in concurrently
        self._lock = threading.Lock()
        # problems / true DP cells / launch pairs solved on self.device
        self.device_problems = 0
        self.device_cells = 0
        self.device_batches = 0
        # launch groups by (route, S_q, S_t): [groups, problems summed,
        # the most problems in one group]
        self.launch_groups: dict[tuple[str, int, int], list[int]] = {}

    def align_codes(self, query: np.ndarray, target: np.ndarray
                    ) -> list[tuple[str, int]]:
        """Global alignment of one pair of code arrays -> CIGAR list."""
        return self.align_batch([(query, target)])[0]

    # Up to the reference's 60 Kbp chunk regime ((120k)*(60k) rotated
    # cells ~= 7.2 GB traceback buffer, cf. its documented ~7 GB peak RAM);
    # larger problems never occur because align_strings chunks first.
    NATIVE_MAX_CELLS = 1 << 33
    # batches with at least this many problems AND this many DP cells go
    # to the device in one launch pair; the rest to the native scalar DP.
    # The class holds the frozen floors (FROZEN_BATCH_MIN*, the reference
    # package's floors for a directly attached chip); ``devcal.apply``
    # sets the card's measured ones on an aligner instance.
    DEVICE_BATCH_MIN = FROZEN_BATCH_MIN
    DEVICE_BATCH_MIN_CELLS = int(os.environ.get(
        "SEDEF_DEVICE_BATCH_MIN_CELLS", FROZEN_BATCH_MIN_CELLS))
    # on cuda, problems above this many rotated cells always go to the
    # device (a 60 Kbp chunk is ~7.2e9)
    GIANT_CELLS = 1 << 30
    # size classes take one of three routes, by the reference package's
    # rules (so a problem takes the counterpart of the TPU kernel it takes
    # there): classes wider than GIANT_S_T, or whose one-problem matrix
    # (S_q + S_t) * S_t exceeds GIANT_P_BYTES, take the tiled route
    # (checkpoint fill, then per tile a refill and a traceback, from the
    # last tile to the first); classes at least STREAM_MIN_S_T wide with
    # more than STREAM_MIN_PROBLEMS problems take the streamed fill; the
    # rest the direct fill.
    GIANT_S_T = 8192
    GIANT_P_BYTES = 1 << 27
    STREAM_MIN_S_T = 1024
    STREAM_MIN_PROBLEMS = 32
    # problems per stream: one stream per SM of an H100 (132) as long as
    # each chains at least 2 and at most STREAM_K_MAX problems
    STREAM_SMS = 132
    STREAM_K_MAX = 16
    # tiled giant classes with S_t <= S_q and more than GIANT_STREAMS
    # problems run GIANT_STREAMS streams of K problems, K from this ladder
    GIANT_STREAMS = 8
    GIANT_K_LADDER = (2, 3, 4, 6, 8)
    # cap on one launch's direction matrix, n_streams * rows * S_t bytes
    # (direct and streamed routes; one 60 Kbp chunk problem alone is
    # ~7.5 GB), and on one tiled launch's tile rows, n_streams * tile * S_t
    P_BUDGET_BYTES = 8 << 30
    TILE_BUDGET_BYTES = 4 << 30

    def align_batch(self,
                    pairs: GapBatch | list[tuple[np.ndarray, np.ndarray]]
                    ) -> CigarBatch:
        """Align many (query, target) code pairs, given as a ``GapBatch``
        or a list of pairs; returns their CIGARs as a ``CigarBatch``.

        Degenerate problems get their trivial CIGAR; bulk batches and
        giant problems go to ``self.device`` per size class; stragglers go
        to the native C++ scalar DP (everything goes to the device when
        the native library is unavailable).  The routing is masks over
        the batch's length arrays."""
        flat = isinstance(pairs, GapBatch)
        batch = GapBatch.of(pairs)
        from ..native import lib as _nlib
        native = _nlib if _nlib.has("align") else None
        giant = (self.GIANT_CELLS if self.device.type == "cuda"
                 else self.NATIVE_MAX_CELLS)
        ql, tl = batch.ql, batch.tl
        cells = ql * tl
        live = (ql > 0) & (tl > 0)
        big = (ql + tl) * np.maximum(tl, 1) > giant
        host = live & ~big & (native is not None)
        device_idx = np.flatnonzero(live & ~host)
        native_idx = np.flatnonzero(host)
        if (len(native_idx) >= self.DEVICE_BATCH_MIN
                and cells[native_idx].sum() >= self.DEVICE_BATCH_MIN_CELLS):
            device_idx = np.concatenate([device_idx, native_idx])
            native_idx = native_idx[:0]
        dead = np.flatnonzero(~live)
        parts = [(dead, _degenerate_cigars(ql[dead], tl[dead]))
                 ] if len(dead) else []
        groups = dict.fromkeys(ROUTES, 0)
        if len(native_idx):
            with trace.span("gapdp.host"):
                parts.append((native_idx,
                              self._align_native(native, batch, native_idx)))
        if len(device_idx):
            with trace.span("gapdp.card"):
                parts += self._align_device(batch, device_idx, groups)
        GAPDP.update({
            "problems.degenerate": len(dead),
            "problems.host": len(native_idx),
            "problems.card": len(device_idx),
            "cells.host": int(cells[native_idx].sum()),
            "cells.card": int(cells[device_idx].sum()),
            **{f"groups.{r}": n for r, n in groups.items()},
            "flat.problems": len(batch) if flat else 0})
        return CigarBatch.scatter(len(batch), parts)

    def _align_native(self, native, batch: GapBatch, idxs: np.ndarray
                      ) -> CigarBatch:
        """The native scalar DP on the host: one ctypes round trip for
        the whole small-DP set."""
        qbuf, qoff = batch.codes(idxs, 0)
        tbuf, toff = batch.codes(idxs, 1)
        ops, lens, cnt = native.align_batch_flat(
            qbuf, qoff, tbuf, toff, self.match, self.mis, self.gapo,
            self.gape)
        return CigarBatch(ops, lens, _offsets(cnt))

    def _align_device(self, batch: GapBatch, idxs: np.ndarray,
                      routes: dict[str, int]
                      ) -> list[tuple[np.ndarray, CigarBatch]]:
        """Fill + traceback on ``self.device``, grouped per (S_q, S_t) size
        class in the order the classes first occur in ``idxs``, each class
        on its route (see GIANT_S_T above); ``routes`` counts the launch
        groups by route.  Returns each launch group's problems and
        CIGARs."""
        S_q = _pad_to_class(batch.ql[idxs])
        S_t = _pad_to_class(batch.tl[idxs])
        _, seen, cls = np.unique(S_q << 32 | S_t, return_index=True,
                                 return_inverse=True)
        rank = np.empty(len(seen), np.int64)
        rank[np.argsort(seen)] = np.arange(len(seen))
        order = np.argsort(rank[cls.ravel()], kind="stable")
        ends = _offsets(np.bincount(rank[cls.ravel()]))
        from ..debug import dprn
        out = []
        for a, b in zip(ends[:-1].tolist(), ends[1:].tolist()):
            g = idxs[order[a:b]]
            Sq, St = int(S_q[order[a]]), int(S_t[order[a]])
            dprn("[aligner] class ({}, {}): {} problems", Sq, St, len(g))
            if St > self.GIANT_S_T or (Sq + St) * St > self.GIANT_P_BYTES:
                parts = self.tiled_parts(g, Sq, St)
            elif St >= self.STREAM_MIN_S_T and len(g) > self.STREAM_MIN_PROBLEMS:
                K = self.stream_k(len(g))
                per_stream = _stream_rows(Sq, St, K) * St
                cap = max(1, self.P_BUDGET_BYTES // per_stream) * K
                parts = [(g[o:o + cap], K, None)
                         for o in range(0, len(g), cap)]
            else:
                cap = max(1, self.P_BUDGET_BYTES // ((Sq + St - 1) * St))
                parts = [(g[o:o + cap], 1, None)
                         for o in range(0, len(g), cap)]
            for part, K, tile in parts:
                routes[_route(K, tile)] += 1
                ops = self._solve(batch, part, Sq, St, K, tile)
                with trace.span("gapdp.card.decode"):
                    out.append((part, cigars_from_packed(
                        ops[:len(part)], batch.ql[part], batch.tl[part])))
        return out

    def stream_k(self, n: int) -> int:
        """Problems per stream for a streamed class of n problems."""
        return min(self.STREAM_K_MAX, max(2, -(-n // self.STREAM_SMS)))

    def tiled_parts(self, g: list[int], S_q: int, S_t: int):
        """(problems, K, tile) launch groups of one giant class: streams of
        K problems when S_t <= S_q and there are more than GIANT_STREAMS
        problems, single problems capped by TILE_BUDGET_BYTES otherwise."""
        tile = 4096 if S_q + S_t - 1 >= 4096 else 1024
        if S_t <= S_q and len(g) > self.GIANT_STREAMS:
            parts = []
            off = 0
            while off < len(g):
                want = -(-(len(g) - off) // self.GIANT_STREAMS)
                K = next((k for k in self.GIANT_K_LADDER if want <= k),
                         self.GIANT_K_LADDER[-1])
                parts.append((g[off:off + self.GIANT_STREAMS * K], K, tile))
                off += self.GIANT_STREAMS * K
            return parts
        cap = max(1, self.TILE_BUDGET_BYTES // (tile * S_t))
        return [(g[o:o + cap], 1, tile) for o in range(0, len(g), cap)]

    def _solve(self, batch: GapBatch, part: np.ndarray, S_q: int, S_t: int,
               K: int, tile: int | None) -> np.ndarray:
        """One launch group, the problems ``part`` of ``batch``: packed
        ops (len(part), ceil(n_diag / 4)).

        ``tile`` None: the direct (K = 1) or streamed fill, then the
        traceback.  Otherwise the tiled route, streamed when K > 1.  The
        batch is padded to whole streams with ql = tl = 1 problems."""
        B = -(-len(part) // K) * K
        with trace.span("gapdp.card.pack"):
            qseq = batch.pad(part, 0, B, S_q)
            tgts = batch.pad(part, 1, B, S_t)
            ql = np.ones(B, np.int32)
            tl = np.ones(B, np.int32)
            ql[:len(part)] = batch.ql[part]
            tl[:len(part)] = batch.tl[part]
        dev = self.device
        sc = (self.match, self.mis, self.gapo, self.gape)
        with self._lock:
            with trace.span("gapdp.card.upload"):
                q = torch.from_numpy(qseq).to(dev)
                t = torch.from_numpy(tgts).to(dev)
                qlt = torch.from_numpy(ql).to(dev)
                tlt = torch.from_numpy(tl).to(dev)
            if tile is None:
                if K == 1:
                    p = wavefront_fill(q, t, *sc)
                else:
                    p = wavefront_fill_streamed(q, t, K, *sc)
                packed = backtrack_pack(p, qlt, tlt, K)
                del p
            else:
                packed = self._solve_tiled(q, t, qlt, tlt, K, tile, sc)
            with trace.span("gapdp.card.wait"):
                packed = packed.cpu()
            ops = packed.numpy()
            self.device_problems += len(part)
            self.device_cells += int((ql.astype(np.int64) * tl).sum())
            self.device_batches += 1
            g = self.launch_groups.setdefault((_route(K, tile), S_q, S_t),
                                              [0, 0, 0])
            g[0] += 1
            g[1] += len(part)
            g[2] = max(g[2], len(part))
        return ops

    @staticmethod
    def _solve_tiled(q, t, ql, tl, K: int, tile: int, sc) -> torch.Tensor:
        """Checkpoint fill, then per tile (last first) a refill and a
        traceback step: peak memory is one tile's rows per stream."""
        S_q, S_t = q.shape[1], t.shape[1]
        streamed = K > 1
        if streamed:
            ckpt = tile_checkpoint_streamed(q, t, K, tile, *sc)
        else:
            ckpt = tile_checkpoint(q, t, tile, *sc)
        ws = torch.stack([tl - 1, ql - 1, torch.zeros_like(ql)],
                         dim=1).contiguous()
        out = torch.empty((q.shape[0], (S_q + S_t - 1 + 3) // 4),
                          dtype=torch.uint8, device=q.device)
        for ti in range(ckpt.shape[1] - 1, -1, -1):
            if streamed:
                p_tile = tile_refill_streamed(q, t, ckpt, ti, K, tile, *sc)
                tile_backtrack_streamed(p_tile, ql, tl, ws, out, ti * tile,
                                        S_q, K)
            else:
                p_tile = tile_refill(q, t, ckpt, ti, tile, *sc)
                tile_backtrack(p_tile, ql, tl, ws, out, ti * tile, S_q)
        return out

    def align_strings(self, a: str, b: str) -> list[tuple[str, int]]:
        """Chunked global alignment of raw strings, reproducing the
        reference's 60 Kbp diagonal chunking (``align.cc:46-66``).

        The chunks are independent (the reference simply concatenates
        their CIGARs), so they are aligned as ONE batch."""
        max_len = self.cfg.align.max_ksw_seq_len
        qc_full = encode_align(a)
        tc_full = encode_align(b)
        min_len = min(len(a), len(b))
        # NOTE: like the reference (align.cc:46-47), when min_len == 0 the
        # loop body never runs and the CIGAR is empty; tails of the longer
        # sequence past the final chunk are likewise not consumed.
        chunks = [(qc_full[sp:sp + max_len], tc_full[sp:sp + max_len])
                  for sp in range(0, min_len, max_len)]
        parts = self.align_batch(chunks) if chunks else []
        cigar: list[tuple[str, int]] = []
        for part in parts:
            for op, ln in part:
                if cigar and cigar[-1][0] == op:
                    cigar[-1] = (op, cigar[-1][1] + ln)
                else:
                    cigar.append((op, ln))
        return cigar


class CoalescingAligner:
    """Thread-safe wrapper that merges ``align_batch`` calls issued by
    concurrent workers into single device dispatches.

    The reference fans stage 2b over GNU-Parallel processes
    (``sedef.sh:187-190``); here independent regions run on threads and
    their gap-alignment batches coalesce, so the number of device round
    trips per bucket drops from O(regions x align rounds) to O(align
    rounds) — the decisive factor when per-dispatch latency is high.
    Results are identical to per-call dispatch: the kernel is
    batch-composition independent (each problem is solved in its own
    lanes) and routing (native vs device) is per-problem.
    """

    def __init__(self, base: "WavefrontAligner", window_s: float = 0.004):
        import threading
        self.base = base
        self.cfg = base.cfg
        self.window_s = window_s
        self._cv = threading.Condition()
        self._pending: list[list] = []
        self._dispatching = False

    def align_batch(self, pairs):
        import time as _time
        if not pairs:
            return []
        if self.base.device.type != "cuda":
            # host-only base: nothing to amortize — the window sleep
            # would serialize threads behind a 4 ms pause per round for
            # zero benefit.  The native per-problem path is thread-safe
            # (thread_local buffers), so dispatch directly.
            return self.base.align_batch(pairs)
        req = [pairs, None]
        with self._cv:
            self._pending.append(req)
            if self._dispatching:
                with trace.span("coalesce.wait"):
                    while req[1] is None and self._dispatching:
                        self._cv.wait()
            if req[1] is not None:
                return req[1]
            self._dispatching = True
        try:
            while req[1] is None:
                with trace.span("coalesce.wait"):
                    _time.sleep(self.window_s)
                with self._cv:
                    batch = self._pending
                    self._pending = []
                if not batch:
                    break
                COALESCE.add("rounds")
                results = self.base.align_batch(
                    GapBatch.join([r[0] for r in batch]))
                with self._cv:
                    i = 0
                    for r in batch:
                        n = len(r[0])
                        r[1] = results[i:i + n]
                        i += n
                    self._cv.notify_all()
        finally:
            with self._cv:
                self._dispatching = False
                self._cv.notify_all()
        return req[1]

    def align_codes(self, query, target):
        return self.align_batch([(query, target)])[0]

    def align_strings(self, a: str, b: str):
        return self.base.align_strings(a, b)


def _degenerate_cigars(ql: np.ndarray, tl: np.ndarray) -> CigarBatch:
    """The CIGARs of problems with an empty side: ``D`` of the query,
    then ``I`` of the target, each where it is not empty."""
    lens = np.stack([ql, tl], axis=1)
    keep = lens > 0
    ops = np.broadcast_to(np.frombuffer(b"DI", np.uint8), lens.shape)
    return CigarBatch(ops[keep], lens[keep].astype(np.int32),
                      _offsets(keep.sum(axis=1)))
