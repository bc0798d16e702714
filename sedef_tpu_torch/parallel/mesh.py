"""Counterpart of ``sedef_tpu/parallel/mesh.py``.

Multi-device execution of the batched compute step.

The reference scales by fanning ~n(n+1) independent chromosome-pair
processes over cores via GNU Parallel with the filesystem as the collective
(SURVEY §2.2 P1/C1; ``sedef.sh:133-140``).  The equivalent here:

* a 2-D ``torch.distributed`` device mesh with axes ("pairs", "data") over
  a process group, one rank per shard — chromosome-pair jobs shard over
  "pairs", each job's batched windows/DP problems shard over "data";
* the per-step compute (q-gram filter scoring + the direct fill) runs on
  every rank's shard, followed by collectives: an all-reduce for the global
  funnel counters (the reference's TOTAL/JACCARD/... tallies,
  search.cc:29-31) and an all-gather of per-shard hit counts;
* :class:`MeshAligner` shards the align stage's batches over the devices
  of one process, with no collectives (problems are independent).
"""

from __future__ import annotations

import ctypes
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT
from ..native import kernels
from ..ops import wavefront as wf
from ..ops.filter import QG, QSZ

AXES = ("pairs", "data")


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """The squarest 2-D factorization (pairs, data) of ``n_devices``."""
    p = int(math.isqrt(n_devices))
    while n_devices % p:
        p -= 1
    return p, n_devices // p


def make_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """2-D mesh ("pairs", "data") over the initialised process group of
    ``n_devices`` ranks (every rank of the group)."""
    from torch.distributed.device_mesh import init_device_mesh
    if n_devices is None:
        n_devices = dist.get_world_size()
    return init_device_mesh(device_type, mesh_shape(n_devices),
                            mesh_dim_names=AXES)


def qgram_scores_torch(codes_a: torch.Tensor, codes_b: torch.Tensor
                       ) -> torch.Tensor:
    """``qgram_scores``' plain version.  Batched shared-q-gram counts:
    (..., W) uint8 code windows ->
    (...,) int32 shared 5-gram histogram intersection (filter.cc:55-91
    as a scatter-add over 1024 bins), on the windows' device.  Grams
    outside the bins (codes above 3) are dropped, as the reference's
    scatter drops out-of-range indices."""
    W = codes_a.shape[-1]
    n = W - QG + 1

    def grams(c):
        c = c.to(torch.int32)
        g = torch.zeros(c.shape[:-1] + (n,), dtype=torch.int32,
                        device=c.device)
        for j in range(QG):
            g = (g << 2) | c[..., j:j + n]
        return g

    def hist(g):
        flat = g.reshape(-1, n)
        keep = (flat >= 0) & (flat < QSZ)
        h = torch.zeros((flat.shape[0], QSZ), dtype=torch.int32,
                        device=g.device)
        h.scatter_add_(1, torch.where(keep, flat, 0).long(),
                       keep.to(torch.int32))
        return h.reshape(g.shape[:-1] + (QSZ,))

    return torch.minimum(hist(grams(codes_a)),
                         hist(grams(codes_b))).sum(-1, dtype=torch.int32)


# csrc/qgram.cu's entry point and its C signature
_QGRAM_SCORES_C = ("sedef_qgram_scores", [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def qgram_scores(codes_a: torch.Tensor, codes_b: torch.Tensor
                 ) -> torch.Tensor:
    """The shared-q-gram counts of ``qgram_scores_torch``: on CUDA tensors
    one launch of ``csrc/qgram.cu`` on the current stream (a block a pair,
    no synchronisation), on CPU tensors the plain version."""
    dev = kernels.same_device(codes_a, codes_b)
    if dev.type == "cpu":
        return qgram_scores_torch(codes_a, codes_b)
    nd = codes_a.dim()
    kernels.check(codes_a, torch.uint8, nd, "codes_a")
    kernels.check(codes_b, torch.uint8, nd, "codes_b")
    if nd < 1 or codes_b.shape != codes_a.shape:
        raise ValueError("codes_a and codes_b must be windows of one shape")
    W = codes_a.shape[-1]
    if W < QG - 1:
        raise ValueError(f"windows of {W} codes: the plain version takes "
                         f"{QG - 1} or more")
    lead = codes_a.shape[:-1]
    out = torch.empty(lead, dtype=torch.int32, device=dev)
    if out.numel():
        kernels.launch(KERNEL_WRAPPERS[0], dev,
                       kernels.function(*_QGRAM_SCORES_C), codes_a.data_ptr(),
                       codes_b.data_ptr(), out.data_ptr(), out.numel(), W)
    return out


# the wrapper that launches this module's kernel, with its launch count;
# counted through this tuple, as the ops modules' wrappers are
KERNEL_WRAPPERS = (qgram_scores,)
qgram_scores.launches = 0


def _collective_device(mesh) -> torch.device:
    """Where the step's counters travel: the card for an NCCL group, the
    host for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device(mesh.device_type, torch.cuda.current_device())
    return torch.device("cpu")


def multichip_step(mesh, S_q: int, S_t: int):
    """The sharded compute step (the reference's ``build_multichip_step``):
    q-gram gate -> direct fill -> collective funnel reduction.  Every rank
    calls the returned ``step(qcodes, tgt, win_a, win_b, minqg)`` on its
    shard: qcodes (B, >= S_q) int, tgt (B, S_t) int8, windows (B, W) uint8,
    on the mesh's device.  Returns ``(p, mcells, qg, total, total_passed,
    counts)``: p (B, S_q + S_t - 1, S_t) uint8 direction bytes, mcells (B,)
    and qg (B,) int32, the mesh-wide totals, and counts (data,) int32, the
    passed counts of this rank's "data" row.

    The fill is ``wavefront_fill`` (kernel 1's counterpart on a card), fed
    the first S_q query codes.  ``mcells`` counts the matched-diagonal
    cells (``(p & 7) == 0``) on each problem's band (``stream_band``):
    the kernels leave the bytes outside it undefined, where the reference
    counts every cell of its scan's rows."""
    n_rows = S_q + S_t - 1
    data = mesh.get_group("data")
    dd = mesh.size(AXES.index("data"))

    def step(qcodes, tgt, win_a, win_b, minqg):
        qg = qgram_scores(win_a, win_b)
        passed = qg >= int(minqg)
        p = wf.wavefront_fill(qcodes[:, :S_q].to(torch.int8).contiguous(),
                              tgt.to(torch.int8).contiguous())
        band = wf.stream_band(0, n_rows, S_q, S_t, device=p.device)
        mcells = (((p & 7) == 0) & band).sum(dim=(1, 2), dtype=torch.int32)
        cdev = _collective_device(mesh)
        n_pass = passed.sum(dtype=torch.int32).reshape(1).to(cdev)
        total = torch.tensor([qg.shape[0]], dtype=torch.int32, device=cdev)
        total_passed = n_pass.clone()
        # the mesh spans the whole group: its all-reduce is the world's
        dist.all_reduce(total)
        dist.all_reduce(total_passed)
        counts = [torch.empty_like(n_pass) for _ in range(dd)]
        dist.all_gather(counts, n_pass, group=data)
        return (p, mcells, qg, total[0], total_passed[0],
                torch.cat(counts))

    return step


def example_inputs(pp: int, dd: int, S_q: int = 128, S_t: int = 128,
                   B: int = 2, W: int = 128, seed: int = 0):
    """Tiny global inputs of one step, as NumPy arrays shaped (pp, dd, B,
    ...): rank (i, j) of the mesh takes ``[i, j]``.  qcodes carries the
    S_q + S_t - 1 row codes the reference's scan reads."""
    rng = np.random.default_rng(seed)
    qcodes = rng.integers(0, 4, (pp, dd, B, S_q + S_t - 1)).astype(np.int32)
    tgt = rng.integers(0, 4, (pp, dd, B, S_t)).astype(np.int8)
    win_a = rng.integers(0, 4, (pp, dd, B, W)).astype(np.uint8)
    win_b = win_a.copy()
    flip = rng.random(win_b.shape) < 0.1
    win_b[flip] = rng.integers(0, 4, int(flip.sum()))
    return qcodes, tgt, win_a, win_b, np.int32(10)


class MeshAligner:
    """Align-stage aligner that shards each batch over several devices of
    one process — the multi-device replacement for the reference's
    per-process fan-out (sedef.sh:187-190): problems are independent, so
    the batch axis shards with no collectives.

    ``devices`` (default: every card) holds one ``WavefrontAligner`` each;
    a device may be listed more than once (each entry fills on its own
    host thread and stream).  Each size class's group splits into
    contiguous shards, one per entry, each solved as the direct fill and
    its traceback (kernels 1 and 2 on a card).  Degenerate problems,
    classes wider than ``GIANT_S_T`` and batches of fewer than two
    problems a device take ``base``, the first entry's aligner, on its
    routes.  Results are identical to the single-device aligner: batch
    composition does not affect per-problem DP results."""

    def __init__(self, devices=None, cfg=None):
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError("MeshAligner: no CUDA device is "
                                   "available (list CPU devices explicitly "
                                   "to run the plain PyTorch path)")
        self.aligners = [wf.WavefrontAligner(cfg or DEFAULT, device=d)
                         for d in devices]
        self.base = self.aligners[0]
        self.cfg = self.base.cfg
        self.ndev = len(self.aligners)
        self._streams = [torch.cuda.Stream(al.device)
                         if al.device.type == "cuda" else None
                         for al in self.aligners]

    @property
    def device(self) -> torch.device:
        return self.base.device

    def align_strings(self, a: str, b: str):
        max_len = self.cfg.align.max_ksw_seq_len
        from ..ops.dna import encode_align
        qc_full = encode_align(a)
        tc_full = encode_align(b)
        min_len = min(len(a), len(b))
        chunks = [(qc_full[sp:sp + max_len], tc_full[sp:sp + max_len])
                  for sp in range(0, min_len, max_len)]
        parts = self.align_batch(chunks) if chunks else []
        cigar = []
        for part in parts:
            for op, ln in part:
                if cigar and cigar[-1][0] == op:
                    cigar[-1] = (op, cigar[-1][1] + ln)
                else:
                    cigar.append((op, ln))
        return cigar

    def align_codes(self, query, target):
        return self.align_batch([(query, target)])[0]

    def align_batch(self, pairs):
        """Size-class groups shard over the devices; small stragglers and
        giant tiled problems take the base (single-device) path."""
        if self.ndev <= 1:
            return self.base.align_batch(pairs)
        results = [None] * len(pairs)
        groups: dict[tuple[int, int], list[int]] = {}
        small: list[int] = []
        for idx, (qc, tc) in enumerate(pairs):
            S_q = wf._pad_to_class(len(qc))
            S_t = wf._pad_to_class(len(tc))
            # the base's routes take degenerate problems too
            if (not len(qc) or not len(tc) or S_t > self.base.GIANT_S_T
                    or len(pairs) < 2 * self.ndev):
                small.append(idx)
                continue
            groups.setdefault((S_q, S_t), []).append(idx)
        if small:
            for idx, cig in zip(small, self.base.align_batch(
                    [pairs[i] for i in small])):
                results[idx] = cig
        # per entry, its launch groups: a contiguous shard of every class,
        # each launch's direction matrix capped at P_BUDGET_BYTES
        work: list[list[tuple[list[int], int, int]]] = [
            [] for _ in range(self.ndev)]
        for (S_q, S_t), idxs in groups.items():
            per = -(-len(idxs) // self.ndev)
            cap = max(1, self.base.P_BUDGET_BYTES // ((S_q + S_t - 1) * S_t))
            for d in range(self.ndev):
                shard = idxs[d * per:(d + 1) * per]
                work[d] += [(shard[o:o + cap], S_q, S_t)
                            for o in range(0, len(shard), cap)]

        batch = wf.GapBatch.of(pairs)

        def solve(d: int) -> None:
            al = self.aligners[d]
            for part, S_q, S_t in work[d]:
                part = np.asarray(part)
                ops = al._solve(batch, part, S_q, S_t, 1, None)
                for idx, cig in zip(part.tolist(), wf.cigars_from_packed(
                        ops, batch.ql[part], batch.tl[part])):
                    results[idx] = cig

        def run(d: int) -> None:
            if self._streams[d] is None:
                solve(d)
                return
            with torch.cuda.device(self.aligners[d].device), \
                    torch.cuda.stream(self._streams[d]):
                solve(d)

        busy = [d for d in range(self.ndev) if work[d]]
        with ThreadPoolExecutor(max_workers=max(len(busy), 1)) as ex:
            for fut in [ex.submit(run, d) for d in busy]:
                fut.result()
        return results
