"""Counterpart of ``sedef_tpu/ops/anchors.py``.

Exact k-mer anchor generation (vectorized).

Equivalent of ``generate_anchors`` (``src/chain.cc:24-101``): hash-join of
query/ref k-mers (case-insensitive 2-bit codes, N-containing k-mers
excluded, posting lists capped at 1000), greedy maximal exact-match
extension along diagonals with the per-diagonal ``slide`` dedup.  The
reference's per-seed scan loop becomes: sort/searchsorted join -> per
diagonal, match-run decomposition -> one anchor per (diagonal, run) at the
first seed of the run.  Output order matches the reference's (q, then
posting order = r) emission.

Anchors are rows of an ``(n, 4)`` int32 array, columns ``Q, R, L, HAS_U``
(the reference's ``Anchor`` fields): the native scan's output as it is,
with no object per anchor.
"""

from __future__ import annotations

import numpy as np

from .dna import encode

_N_CODE = 4  # sentinel for is-N in this module

# the anchor array's columns
Q, R, L, HAS_U = range(4)


def _none() -> np.ndarray:
    return np.empty((0, 4), dtype=np.int32)


def _kmer_hashes(seq: str, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(hashes, valid) for all k-mer positions; valid = no N inside
    (chain.cc:28-39 semantics: hash over hash_dna codes, 'N'/'n' tracked
    via last_n)."""
    code, cls = encode(seq)
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty(0, np.int64), np.empty(0, bool)
    # 2k bits: int32 keys for k <= 15 halve the sort/join memory traffic
    dt = np.int32 if 2 * k <= 31 else np.int64
    h = np.zeros(n, dtype=dt)
    for j in range(k):
        h = (h << 2) | code[j:j + n].astype(dt)
    raw = np.frombuffer(seq.encode(), dtype=np.uint8)
    is_n = (raw == ord("N")) | (raw == ord("n"))
    pn = np.concatenate([[0], np.cumsum(is_n)])
    valid = (pn[k:] - pn[:-k]) == 0
    return h, valid


def generate_anchors(query: str, ref: str, same_chr: bool,
                     orig_query_start: int, orig_ref_start: int,
                     kmer_size: int, max_posting: int = 1000
                     ) -> np.ndarray:
    """The anchors of ``query`` against ``ref``: ``(n, 4)`` int32 rows
    (q, r, len, has_u), q ascending, then r."""
    try:
        from ..native import lib as _native
    except Exception:  # pragma: no cover
        _native = None
    if (_native is not None and _native.has("anchors")
            and 2 * kmer_size <= 24):
        # native scalar scan: ~6x the vectorized numpy join on the
        # production region sizes (profiled round 4: generate_anchors
        # was 67% of align-stage region time)
        return _native.anchors(query.encode(), ref.encode(), same_chr,
                               orig_query_start, orig_ref_start,
                               kmer_size, max_posting)
    qh, qv = _kmer_hashes(query, kmer_size)
    rh, rv = _kmer_hashes(ref, kmer_size)
    if qh.size == 0 or rh.size == 0:
        return _none()

    r_pos = np.nonzero(rv)[0].astype(np.int64)
    if r_pos.size == 0:
        return _none()
    r_hash = rh[r_pos]
    order = np.argsort(r_hash, kind="stable")  # stable keeps r ascending
    r_hash_s = r_hash[order]
    r_pos_s = r_pos[order]

    # posting-list boundaries of the sorted ref hashes (r_hash_s is
    # sorted, so distinct-run extraction is a neighbour compare — no
    # second sort, and the join needs ONE searchsorted over the distinct
    # keys instead of two over the full array)
    bound = np.empty(r_hash_s.size, dtype=bool)
    bound[0] = True
    np.not_equal(r_hash_s[1:], r_hash_s[:-1], out=bound[1:])
    uidx = np.nonzero(bound)[0]
    uniq = r_hash_s[uidx]
    ucnt = np.diff(np.append(uidx, r_hash_s.size))

    q_pos = np.nonzero(qv)[0].astype(np.int64)
    q_hash = qh[q_pos]
    p = np.minimum(np.searchsorted(uniq, q_hash), len(uniq) - 1)
    found = uniq[p] == q_hash
    lo = uidx[p]
    sizes = np.where(found, ucnt[p], 0)
    ok = found & (sizes < max_posting)  # chain.cc:61 (>= 1000 skipped)
    q_pos, lo, sizes = q_pos[ok], lo[ok], sizes[ok]
    if q_pos.size == 0:
        return _none()

    # expand the join into (q, r) pair arrays, q-major then posting order
    pair_q = np.repeat(q_pos, sizes)
    total = int(sizes.sum())
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    idx = (np.arange(total, dtype=np.int64)
           - np.repeat(off, sizes) + np.repeat(lo, sizes))
    pair_r = r_pos_s[idx]

    if same_chr:
        keep = np.abs((orig_ref_start + pair_r)
                      - (orig_query_start + pair_q)) > kmer_size
        pair_q, pair_r = pair_q[keep], pair_r[keep]
    if pair_q.size == 0:
        return _none()

    # Candidate anchors: a pair (q, r) can start an anchor only if its
    # predecessor pair (q-1, r-1) is absent from the (filtered) join — the
    # predecessor would otherwise own the same match run and the slide
    # check would skip (q, r).  Fully vectorized: sort by (diag, q) and
    # compare neighbours.  The (rare) case where the predecessor was
    # dropped by the posting cap but (q, r) lies inside the previous
    # anchor's run is handled by the per-diagonal slide pass below.
    qlen, rlen = len(query), len(ref)
    off = qlen
    diag = off + pair_r - pair_q
    order = np.lexsort((pair_q, diag))
    dq, qq, rr = diag[order], pair_q[order], pair_r[order]
    has_pred = np.zeros(len(qq), dtype=bool)
    has_pred[1:] = (dq[1:] == dq[:-1]) & (qq[1:] == qq[:-1] + 1)
    cand = np.nonzero(~has_pred)[0]
    cq = qq[cand]
    cr = rr[cand]
    cd = dq[cand]

    qraw = np.frombuffer(query.encode(), dtype=np.uint8)
    rraw = np.frombuffer(ref.encode(), dtype=np.uint8)
    qU = np.where((qraw >= 97) & (qraw <= 122), qraw - 32, qraw)
    rU = np.where((rraw >= 97) & (rraw <= 122), rraw - 32, rraw)
    up_any = (((qraw >= 65) & (qraw <= 90))).astype(np.int64)
    r_up = (((rraw >= 65) & (rraw <= 90))).astype(np.int64)
    q_isn = qU == ord("N")
    r_isn = rU == ord("N")

    # exact-match run length per candidate: extend ALL candidates in
    # lockstep, 64-byte chunks, via fancy-indexed gathers (a per-candidate
    # suffix compare is O(candidates x run) with Python overhead per
    # candidate; this is O(candidates x run/64) pure numpy)
    CH = 64
    # pads chosen to always mismatch each other and to read as "N"
    q_cmp = np.where(q_isn, np.uint8(1), qU)
    r_cmp = np.where(r_isn, np.uint8(2), rU)
    q_cmp = np.concatenate([q_cmp, np.full(CH, 1, np.uint8)])
    r_cmp = np.concatenate([r_cmp, np.full(CH, 2, np.uint8)])
    nmax = np.minimum(qlen - cq, rlen - cr)
    ln_all = np.zeros(len(cq), dtype=np.int64)
    alive = np.arange(len(cq))
    t = 0
    col = np.arange(CH)
    while alive.size:
        qa, ra = cq[alive], cr[alive]
        m = (q_cmp[np.minimum(qa[:, None] + t + col, qlen + CH - 1)]
             == r_cmp[np.minimum(ra[:, None] + t + col, rlen + CH - 1)])
        m &= (t + col) < nmax[alive, None]
        full = m.all(axis=1)
        first = np.where(full, CH, m.argmin(axis=1))
        ln_all[alive] += first
        alive = alive[full & (t + CH < nmax[alive])]
        t += CH

    # has_u from uppercase prefix sums over both mates
    pu_q = np.concatenate([[0], np.cumsum(up_any)])
    pu_r = np.concatenate([[0], np.cumsum(r_up)])
    has_u_all = ((pu_q[cq + ln_all] - pu_q[cq])
                 + (pu_r[cr + ln_all] - pu_r[cr])) > 0

    # per-diagonal slide pass in (diag, q) order (chain.cc:64-98)
    kept = np.zeros(len(cq), dtype=bool)
    slide: dict[int, int] = {}
    for i, (q0, d, ln) in enumerate(zip(cq.tolist(), cd.tolist(),
                                        ln_all.tolist())):
        if q0 >= slide.get(d, -1):
            assert ln >= kmer_size
            kept[i] = True
            slide[d] = q0 + ln
    out = np.stack([cq[kept], cr[kept], ln_all[kept], has_u_all[kept]],
                   axis=1).astype(np.int32)
    # reference emission order: q ascending, then r ascending
    return out[np.lexsort((out[:, R], out[:, Q]))]
