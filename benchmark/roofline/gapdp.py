"""The least time of a gap DP: the work its inputs need, whatever kernel
does it.

A gap DP of a query of length ql and a target of length tl is SEDEF's global
affine-gap alignment (ksw2's ``extz2`` difference recurrence, with the
direction bits a traceback needs): ql x tl cells, as the aligner's own
``device_cells`` counts them.  One cell of the recurrence needs, at the
fewest instructions of the widest integer SIMD the card has at a 16-bit
score (Hopper's DPX forms fuse an add with a max and a max with its test):

  1  the substitution score of the two bases (a table read);
  2  a = x[t-1] + v[t-1] and b = y[t] + u[t];
  2  z = max(score + q + e, a), then max(z, b), each with its test, which
     give the direction's two bits;
  1  the clamp z = min(z, max_sc);
  1  z' = gapo - z;
  2  x = max(a + z', 0) and y = max(b + z', 0), an add fused with a max
     (their signs give the two gap-extension bits);
  2  u = z - v[t-1] and v = z - u[t].

11 lane operations a cell (``OPS_PER_CELL``).  The loads, stores and the
shifts that move a lane's neighbour are not counted, nor the packing of the
direction bits: an implementation can only need more.  At 16-bit scores
(SEDEF's scoring fits, ``dpx2_scoring_fits``) two cells share one int32
operation, so the peak is two lanes an int32 operation (``peaks.py``).

Bytes: each input base once (ql + tl), and the path out once: ql + tl
moves at two bits each.  The least time is the larger of operations over
the peak and bytes over the memory bandwidth.
"""

from __future__ import annotations

import numpy as np

OPS_PER_CELL = 11


def least_seconds(ql: np.ndarray, tl: np.ndarray, pk: dict) -> float:
    """The least time of the problems with these lengths, in seconds."""
    ql = np.asarray(ql, dtype=np.int64)
    tl = np.asarray(tl, dtype=np.int64)
    ops = float(OPS_PER_CELL * (ql * tl).sum())
    nbytes = float((ql + tl).sum() + np.ceil((ql + tl) / 4).sum())
    lane_ops = pk["int32_ops_per_s"] * pk["lanes_per_int32_op_16bit"]
    return max(ops / lane_ops, nbytes / pk["hbm_bytes_per_s"])


KERNELS = frozenset({
    # csrc/wavefront_fill.cu, csrc/fill_owned.cuh
    "fill_warp_kernel", "fill_owned", "fill_owned_streamed",
    # csrc/tile_fill_cluster.cu
    "tile_fill_cluster",
    # csrc/traceback_pack.cu
    "walk_thread_kernel", "walk_window_kernel",
    # csrc/wavefront_fill_variants.cu
    "fill_base", "fill_reg", "fill_dpx2", "fill_chain",
})


def share(ctx: dict) -> float | None:
    """100 x the window's least gap-DP time over the device time of its
    gap-DP kernels; None where the card ran none or its peak is unknown."""
    pk = ctx.get("peak")
    trace = ctx.get("trace")
    groups = ctx.get("gapdp") or []
    if pk is None or trace is None or not groups:
        return None
    dev = sum(s for name, s in trace.kernels if name in KERNELS)
    if dev <= 0:
        return None
    least = sum(least_seconds(ql, tl, pk) for ql, tl in groups)
    return 100.0 * least / dev
