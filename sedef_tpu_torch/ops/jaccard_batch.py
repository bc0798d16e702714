"""Counterpart of ``sedef_tpu/ops/jaccard_batch.py``.

Batched MinHash-sketch Jaccard scoring on a device.

The batched formulation of the sliding-Jaccard statistic (SURVEY §7.1):
instead of rolling an incremental ordered map one position at a time
(sliding.cc), score MANY candidate window compositions at once as a
union-rank reduction over sorted key arrays.

Semantics note: this computes the IDEAL sketch intersection — the number
of keys present in both sets among the |Q| smallest of the union.  The
reference's incremental structure drifts from that ideal through its
boundary-add quirk (a ref bit landing exactly on the boundary element is
not counted, sliding.cc:86), making its value path-dependent on insertion
order — and that drift is one-sided (missed increments only), so the
ideal bounds the reference's counter from above.  This is the core
reduction of the stage-1 roll prefilter
(ops/prefilter.py::_composition_ideals_torch): intervals whose maximum
ideal over all window compositions is below the relaxed Jaccard cutoff
are proven to fail the gate and never rolled on the host.
"""

from __future__ import annotations

import numpy as np
import torch

# int32 keys: packed (status, hash) keys fit in 2k+2 <= 30 bits for
# k <= 14 (the device-path constraint)
INF = 2 ** 31 - 1


def merge_rank_intersection(q_keys: torch.Tensor, r_keys: torch.Tensor,
                            q_size: torch.Tensor) -> torch.Tensor:
    """Core union-rank reduction: one tagged concat-sort per row, no
    per-element binary searches.

    Each row's query and ref keys are tagged into one array
    (``key*2 + side``; the query side sorts first for equal keys), sorted
    once, and scanned with vector compares and a cumulative sum:

    * a DISTINCT union element starts wherever ``key`` changes
      (``new_key``); its 0-based distinct rank is ``cumsum(new_key)-1``;
    * a SHARED key is a query-side element immediately followed by the
      same key (the only query occurrence sorts before the ref copies),
      counted iff its rank is below ``q_size`` (sketch boundary,
      inclusive).

    q_keys rows must be sorted and DISTINCT (INF-padded); r_keys rows
    sorted, INF-padded, duplicates allowed (they collapse via new_key).
    All int32.  Tag headroom: packed (status, hash) keys use 2k+2 <= 30
    bits for k <= 14, so key*2+1 < 2^31 never wraps and INF (2^31-1) stays
    the largest value.  Returns (B,) int32.
    """
    B = q_keys.shape[0]
    dev = q_keys.device
    aq = torch.where(q_keys == INF, INF, q_keys * 2)
    ar = torch.where(r_keys == INF, INF, r_keys * 2 + 1)
    arr = torch.sort(torch.cat([aq, ar], dim=1), dim=1).values
    key = arr >> 1
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=dev),
                      key[:, :-1]], dim=1)
    new_key = (key != prev) & (arr != INF)
    rank = torch.cumsum(new_key, dim=1, dtype=torch.int32) - 1
    nxt = torch.cat([key[:, 1:],
                     torch.full((B, 1), -2, dtype=torch.int32, device=dev)],
                    dim=1)
    shared = new_key & ((arr & 1) == 0) & (nxt == key)
    return (shared & (rank < q_size[:, None])).sum(dim=1, dtype=torch.int32)


def sketch_intersection(q_keys: torch.Tensor, r_keys: torch.Tensor,
                        q_size: torch.Tensor) -> torch.Tensor:
    """Ideal sketch intersections, batched.

    q_keys: (B, S) sorted distinct query keys (int32), padded with INF
    r_keys: (B, M) sorted ref keys (HAS_N excluded), INF-padded;
        duplicates allowed — they collapse inside the union-rank
        reduction via its ``new_key`` distinct-element detection
    q_size: (B,) true |Q| per row
    Returns (B,) int32: |{k in Q ∩ R : rank_union(k) < |Q|}| — the count of
    shared keys inside the |Q|-smallest union window (boundary inclusive).
    """
    return merge_rank_intersection(q_keys, r_keys, q_size)


def windows_to_arrays(window_key_sets: list[np.ndarray], pad_to: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-size sorted key sets into an INF-padded matrix."""
    B = len(window_key_sets)
    out = np.full((B, pad_to), INF, dtype=np.int32)
    sizes = np.zeros(B, dtype=np.int32)
    for i, ks in enumerate(window_key_sets):
        k = np.unique(ks)
        k = k[: pad_to]
        out[i, : len(k)] = k
        sizes[i] = len(k)
    return out, sizes
