"""Counterpart of ``sedef_tpu/ops/index.py``.

Minimizer index over a packed sequence.

Array-based equivalent of the reference ``Index`` (``src/hash.h:50-68``,
``src/hash.cc:113-161``): instead of an ``unordered_map<Hash, list<int>>`` we
keep the minimizers twice —

* ``keys``/``locs``: sorted by locus (the scan order the search engine walks);
* ``skeys``/``slocs``: sorted by (key, locus) with ``searchsorted`` lookup —
  the posting "lists" are contiguous slices of ``slocs``.

The frequency threshold drops the top INDEX_CUTOFF=0.001 % most frequent
hashes exactly like ``hash.cc:124-140``.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT, Config
from .dna import PackedSeq
from .winnow import minimizers


class MinimizerIndex:
    def __init__(self, seq: PackedSeq, kmer_size: int, window_size: int,
                 separate_lowercase: bool = True, cfg: Config = DEFAULT,
                 use_device=None):
        """``use_device``: the device of the index build (a torch device
        or its name), or None / False for the host.  The device builds the
        index only where the native C++ scan is absent: that scan is the
        fastest route wherever it exists."""
        self.seq = seq
        self.kmer_size = kmer_size
        self.window_size = window_size
        dev = None
        from .winnow import _native
        native_winnow = _native is not None and _native.has("winnow")
        if use_device and separate_lowercase and not native_winnow:
            # full index build (winnow + posting sort) on the device
            from .winnow_device import device_index_arrays
            dev = device_index_arrays(seq.code, seq.cls, kmer_size,
                                      window_size, device=use_device)
        if dev is not None:
            keys, locs, self.skeys, self.slocs = dev
            self.keys = keys
            self.locs = locs
        else:
            keys, locs = minimizers(seq.code, seq.cls, kmer_size,
                                    window_size, use_device=use_device)
            if not separate_lowercase:
                # ALL_LOWERCASE collapses into HAS_UPPERCASE (hash.cc:81-83)
                status = keys >> (2 * kmer_size)
                keys = np.where(status == 1,
                                keys - (1 << (2 * kmer_size)), keys)
            self.keys = keys          # int64, in locus order
            self.locs = locs          # int32, ascending
            if (_native is not None and _native.has("sort_minimizers")
                    and len(keys) and 2 * kmer_size + 2 <= 31):
                self.skeys, self.slocs = _native.sort_minimizers(keys,
                                                                 locs)
            else:
                order = np.argsort(keys, kind="stable")
                self.skeys = keys[order]
                self.slocs = locs[order]

        # Frequency threshold (hash.cc:124-140): let ``ignore`` be the number
        # of distinct hashes we may drop; walking posting-list sizes from the
        # largest, the threshold is the smallest size still within budget.
        ignore = int((len(keys) * cfg.hash.index_cutoff) / 100.0)
        if len(self.skeys):
            # skeys is sorted: neighbour-compare beats np.unique's
            # re-sort (1.7 -> ~0.2 s at 7M minimizers)
            bound = np.empty(len(self.skeys), dtype=bool)
            bound[0] = True
            np.not_equal(self.skeys[1:], self.skeys[:-1], out=bound[1:])
            uidx = np.nonzero(bound)[0]
            uniq = self.skeys[uidx]
            counts = np.diff(np.append(uidx, len(self.skeys)))
        else:
            uniq = self.skeys[:0]
            counts = np.zeros(0, dtype=np.int64)
        self.threshold = 1 << 31
        if len(counts):
            sizes, nsizes = np.unique(counts, return_counts=True)
            acc = 0
            for sz, cnt in zip(sizes[::-1], nsizes[::-1]):
                acc += int(cnt)
                if acc <= ignore:
                    self.threshold = int(sz)
                else:
                    break
        self._uniq = uniq
        if len(uniq):
            self._starts = uidx
            self._ends = np.append(uidx[1:], len(self.skeys))
        else:
            self._starts = np.zeros(0, dtype=np.int64)
            self._ends = np.zeros(0, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.keys)

    def device_arrays(self, device="cuda"):
        """(keys int32, locs int32) on ``device``, for the roll engine and
        the prefilter (uploaded once; packed keys fit int32 for k <= 14).

        Cached per device: in the stage-1 rotation of pair jobs over the
        cards (models/pipeline.py search_stage) each card keeps its own
        copy."""
        import torch
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        cache = self.__dict__.setdefault("_dev", {})
        arrays = cache.get(dev)
        if arrays is None:
            arrays = cache[dev] = tuple(
                torch.from_numpy(a.astype(np.int32)).to(dev)
                for a in (self.keys, self.locs))
        return arrays

    def posting_buckets(self) -> tuple[np.ndarray, int]:
        """16-bit radix bucket index over ``skeys`` for the native
        posting lookup: (bucket_lo int32[65537], shift) with
        bucket_lo[b] = first skeys index whose key >> shift >= b.  The
        per-key binary search shrinks from log2(nmin) probes over the
        whole array to a short scan inside one bucket.  Cached."""
        cached = getattr(self, "_pbuckets", None)
        if cached is None:
            bits = 2 * self.kmer_size + 2
            shift = max(0, bits - 16)
            bounds = np.arange(65537, dtype=np.int64) << shift
            lo = np.searchsorted(self.skeys, bounds,
                                 side="left").astype(np.int32)
            cached = self._pbuckets = (np.ascontiguousarray(lo), shift)
        return cached

    def find_minimizers(self, p: int) -> int:
        """Index of first minimizer with loc >= p (``hash.cc:143-161``)."""
        return int(np.searchsorted(self.locs, p, side="left"))

    def posting(self, key: int) -> np.ndarray:
        """Loci of all minimizers with this key (ascending)."""
        lo = np.searchsorted(self.skeys, key, side="left")
        hi = np.searchsorted(self.skeys, key, side="right")
        if hi == lo:
            return np.empty(0, dtype=np.int32)
        return np.sort(self.slocs[lo:hi])

    def posting_size(self, key: int) -> int:
        lo = np.searchsorted(self.skeys, key, side="left")
        hi = np.searchsorted(self.skeys, key, side="right")
        return int(hi - lo)

    def status_of(self, key: int) -> int:
        return int(key >> (2 * self.kmer_size))
