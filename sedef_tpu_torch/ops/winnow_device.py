"""Counterpart of ``sedef_tpu/ops/winnow_device.py``.

Device winnowed-minimizer extraction and index build.

Tensor formulation of ``get_minimizers`` + ``Index`` construction
(``src/hash.cc:53-141``), built on the closed form proved in
``ops/winnow.py``:

    minimizer positions  =  { p : key[p] <= min(key[max(0,p-w) .. p-1]) }

Every step is a batched tensor op on the device the caller names:

* rolling 2-bit k-mer pack — k shift-or steps (int32; the packed
  (status, hash) key needs 2k+2 bits, so the device path requires k <= 14;
  the reference default is k = 12),
* HAS_N / HAS_UPPERCASE window status — log2(k) shift-max steps,
* sliding-window minimum — log2(w) shift-min doubling steps
  (sparse-table combine, exact for any w),
* minimizer compaction — a masked cumulative sum scattered into a
  capacity-sized buffer (no host sync until the count is read),
* posting-list order — one stable device sort (ties resolved by locus
  order exactly like the host ``np.argsort(kind="stable")``).

A chromosome is processed in segments of ``_SEG`` positions with w + k - 1
codes of left context (winnowing is position-local).  The minimizer
capacity of a segment is 1/6 of its k-mer count (the quirky winnow emits
~5.6 % of positions on DNA); on overflow the caller falls back to the host
scan.

On a card a segment is one call of ``csrc/device_index.cu`` (three
launches: tile counts, their scan, the ordered write), a block a tile of
2,048 positions with its halo in shared memory; the steps above are the
plain version, ``_device_index_torch``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..native import kernels
from .winnow import STATUS_ALL_LOWERCASE, STATUS_HAS_N, STATUS_HAS_UPPERCASE

INF32 = 2**31 - 1

# inputs up to this many codes run as one segment whose capacity is that of
# a segment of this size (the reference's smallest shape)
_MIN_PAD = 1 << 14

# segment length in codes; each segment after the first re-reads w k-mers
# of left context for the window minimum
_SEG = 1 << 22


def _sliding_min_prev(keys: torch.Tensor, w: int) -> torch.Tensor:
    """W[p] = min(keys[p-w .. p-1]) with +INF where the range is empty."""
    n = keys.shape[0]
    pad = torch.full((w,), INF32, dtype=torch.int32, device=keys.device)
    m = torch.cat([pad, keys])  # m[i] = keys[i - w]
    # sparse table: m[i] = min(arr[i .. i+s-1])
    s = 1
    while s * 2 <= w:
        m = torch.minimum(m[:-s], m[s:])
        s *= 2
    # combine two width-s windows covering [p, p+w)
    return torch.minimum(m[:n], m[w - s:w - s + n])


def _windowed_or(bits: torch.Tensor, k: int, nk: int) -> torch.Tensor:
    """out[p] = any(bits[p .. p+k-1]) via log2(k) shift-max doubling."""
    m = bits
    s = 1
    while s * 2 <= k:
        m = torch.maximum(m[:-s], m[s:])
        s *= 2
    return torch.maximum(m[:nk], m[k - s:k - s + nk])


def _device_index_torch(code: torch.Tensor, cls: torch.Tensor,
                        nk_valid: int, k: int, w: int, cap: int,
                        drop: int = 0):
    """``_device_index``' plain version.  code, cls: (n,) uint8 on the
    device.  Returns (count, locs, keys):
    count a 0-d int32 tensor, locs and keys (cap,) int32, nk/INF-padded
    past ``count`` (and cut at ``cap`` when count > cap).

    K-mer positions at or past ``nk_valid`` never emit.  ``drop`` > 0 marks
    a continuation segment: the first ``drop`` k-mer positions are left
    context for the sliding minimum only (their change points were emitted
    by the previous segment) and the sequence-start emission rule does not
    apply."""
    n = code.shape[0]
    nk = n - k + 1
    dev = code.device

    # rolling 2-bit pack
    codes = code.to(torch.int32)
    h = torch.zeros(nk, dtype=torch.int32, device=dev)
    for j in range(k):
        h = (h << 2) | codes[j:j + nk]

    # window status (kmer_keys_np equivalent)
    has_n = _windowed_or((cls == 2).to(torch.uint8), k, nk) > 0
    has_u = _windowed_or((cls == 0).to(torch.uint8), k, nk) > 0
    status = torch.where(
        has_n, STATUS_HAS_N,
        torch.where(has_u, STATUS_HAS_UPPERCASE,
                    STATUS_ALL_LOWERCASE)).to(torch.int32)
    keys = (status << (2 * k)) | h

    # closed-form change points (ops/winnow.py module doc)
    W = _sliding_min_prev(keys, w)
    idx = torch.arange(nk, dtype=torch.int32, device=dev)
    cmask = (keys <= W) & (idx < nk_valid)

    # emission starts at the front active at p == w (hash.cc:93-97): keep
    # the LAST change point <= w plus everything after it.  Continuation
    # segments (drop > 0) instead suppress their left-context kmers.
    if drop > 0:
        start = drop
    else:
        start = torch.where(cmask & (idx <= w), idx, -1).max()
    emit = cmask & (idx >= start)

    # compaction: the i-th emitted position goes to slot i; slot ``cap``
    # takes every position past the capacity and is cut off
    count = emit.sum(dtype=torch.int32)
    slot = torch.cumsum(emit, 0, dtype=torch.int32) - 1
    slot = torch.where(emit & (slot < cap), slot, cap).long()
    locs = torch.full((cap + 1,), nk, dtype=torch.int32, device=dev)
    locs.scatter_(0, slot, idx)
    locs = locs[:cap]
    valid = locs < nk
    mkeys = torch.where(valid, keys[torch.clamp(locs, max=nk - 1).long()],
                        INF32)
    return count, locs, mkeys


# positions a block of csrc/device_index.cu, and the widest window its
# shared memory holds
_INDEX_TILE = 2048
_INDEX_MAX_W = 1024


# csrc/device_index.cu's entry point and its C signature
_DEVICE_INDEX_C = ("sedef_device_index", [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _device_index(code: torch.Tensor, cls: torch.Tensor, nk_valid: int,
                  k: int, w: int, cap: int, drop: int = 0):
    """One segment's minimizers, as ``_device_index_torch``: on CUDA
    tensors one call of ``csrc/device_index.cu`` on the current stream
    (three launches, no synchronisation), on CPU tensors the plain
    version."""
    dev = kernels.same_device(code, cls)
    if dev.type == "cpu":
        return _device_index_torch(code, cls, nk_valid, k, w, cap, drop)
    kernels.check(code, torch.uint8, 1, "code")
    kernels.check(cls, torch.uint8, 1, "cls")
    n = code.shape[0]
    if cls.shape[0] != n:
        raise ValueError("code and cls must have one length")
    if not 1 <= k <= 14:
        raise ValueError(f"k {k} is not in [1, 14] (packed int32 keys)")
    if not 1 <= w <= _INDEX_MAX_W:
        raise ValueError(f"w {w} is not in [1, {_INDEX_MAX_W}]")
    if n < k or cap < 0:
        raise ValueError(f"a segment of {n} codes holds no {k}-mer, or "
                         f"cap {cap} < 0")
    nb = -(-(n - k + 1) // _INDEX_TILE)
    scratch = torch.empty(2 * nb, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    locs = torch.empty(cap, dtype=torch.int32, device=dev)
    keys = torch.empty(cap, dtype=torch.int32, device=dev)
    kernels.launch(KERNEL_WRAPPERS[0], dev,
                   kernels.function(*_DEVICE_INDEX_C), code.data_ptr(),
                   cls.data_ptr(), scratch.data_ptr(),
                   scratch[nb:].data_ptr(), count.data_ptr(),
                   locs.data_ptr(), keys.data_ptr(), n, int(nk_valid), k, w,
                   cap, int(drop), nb)
    return count, locs, keys


# the wrapper that launches this module's kernel, with its launch count;
# counted through this tuple, so that a caller that wraps the module's
# ``_device_index`` (chip_smoke.py's op timer) leaves the count alone
KERNEL_WRAPPERS = (_device_index,)
_device_index.launches = 0


def _run_segments(code: torch.Tensor, cls: torch.Tensor, k: int, w: int):
    """Dispatches every segment and returns [(lo, count, locs, keys)] and
    the capacity of a segment; no result is read yet."""
    n = code.shape[0]
    seg = _MIN_PAD if n <= _MIN_PAD else _SEG
    cap = (seg - k + 1) // 6
    nk_seg = seg - k + 1
    pending = []
    p0 = 0  # first kmer position this segment emits
    while p0 < n - k + 1:
        lo = max(0, p0 - w)  # w kmers of left context for the window min
        hi = min(lo + seg, n)
        drop = p0 - lo  # overlap kmers to suppress (0 for the first)
        count, locs, keys = _device_index(
            code[lo:hi], cls[lo:hi], hi - lo - k + 1, k, w, cap, drop)
        pending.append((lo, count, locs, keys))
        p0 = lo + nk_seg  # next segment emits from the first unseen kmer
    return pending, cap


def device_index_arrays(code: np.ndarray, cls: np.ndarray, k: int, w: int,
                        device="cuda"):
    """Full minimizer-index arrays, computed on ``device``.

    Returns (keys int64, locs int32, skeys int64, slocs int32) exactly
    matching the host ``minimizers_np`` + stable key sort, or ``None`` when
    the device path does not apply (k > 14, tiny input, or capacity
    overflow — callers fall back to the host scan)."""
    if k > 14:
        return None
    n = code.shape[0]
    if n - k + 1 <= w:
        return None
    dev = torch.device(device)
    code_d = torch.from_numpy(np.ascontiguousarray(code)).to(dev)
    cls_d = torch.from_numpy(np.ascontiguousarray(cls)).to(dev)
    pending, cap = _run_segments(code_d, cls_d, k, w)
    counts = torch.stack([c for _, c, _, _ in pending]).cpu().tolist()
    if max(counts) > cap:  # pragma: no cover - genome-dependent
        return None
    keys = torch.cat([dk[:c] for (_, _, _, dk), c in zip(pending, counts)])
    locs = torch.cat([dl[:c] + lo
                      for (lo, _, dl, _), c in zip(pending, counts)])
    skeys, order = torch.sort(keys, stable=True)
    slocs = locs[order]
    return (keys.cpu().numpy().astype(np.int64), locs.cpu().numpy(),
            skeys.cpu().numpy().astype(np.int64), slocs.cpu().numpy())


def minimizers_device(code: np.ndarray, cls: np.ndarray, k: int, w: int,
                      device="cuda"):
    """(keys, locs) via the device op; None if not applicable."""
    r = device_index_arrays(code, cls, k, w, device)
    if r is None:
        return None
    keys, locs, _, _ = r
    return keys, locs
