#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sedef_tpu_torch``) on one card.

    python3 chip_smoke.py [--spread N] [--profile] [--main-only]
                          [--dense-mbp N]

Phases, one line each or more (any failure exits non-zero, with no result
line):

1. the card: ``nvidia-smi`` name and power limit, torch / CUDA versions;
2. build: the native host runtime and the CUDA kernels, from this
   checkout's sources;
3. every kernel against its plain PyTorch version on the card, at the
   size classes stage 2b produces (plus one 60 Kbp chunk problem on the
   direct and the tiled route, whose plain fill runs once for both; a
   direct line names the fill's plan:
   organisation, cluster size C, lanes per block W, lanes a thread,
   problems a block; a tiled line the cluster tile fill's: C, W, rows per
   cluster barrier N, and the clusters the card holds at once; past 10
   tiles the plain refill and walk run on every third tile): 0
   mismatching direction bytes on every written lane, 0 mismatching
   checkpoint words, packed-op bytes and walker states, and CIGARs equal
   to the NumPy reference on a subset; every organisation the direct
   fill's plan can choose, forced at a small shape; the streamed fill
   under its card's plan and forced into every organisation of
   ``stream_plan`` at the streamed shapes (a line names each plan and its
   time); the walker under
   every walk plan, on walkers that leave on the left and the top edge and
   on a class whose width is no multiple of 16; every fill variant against
   the plain fill on the variant harness's golden problem and at every
   shape of ``kbench.VARIANT_SHAPES`` it takes (the harness shape, a
   card-filling batch and the main path's launch groups), then timed there
   beside kernel 1 against three bounds (``[variants]`` lines), with the
   SASS instructions of each row body and the registers of each kernel;
4. the calibration path, through its entry points: the variant harness
   (``sedef_tpu_torch.tools.kbench``) and ``devcal`` (dispatch cost of one
   launch group, the host's DP rate, the derived batch floors, and the
   measured device/host crossover over batch size), one JSON line;
5. the main path, ``run_pipeline`` on two 20 Mbp genomes at the calibrated
   floors: ``bench.py``'s end-to-end spec (also at 2^18 cells) and a
   mosaic-SD genome whose SDs carry multi-Kbp diverged cores, so the wide
   and giant gap-DP classes occur.  The card route (aligner on ``cuda``)
   must give the same aligned.bed and final.bed bytes as the host route
   (every gap DP on the native scalar DP, the reference package's CPU
   route), and kernels 1-9 must have been launched by the card runs, the
   variant kernel by the calibration path; a ``[main]`` line per run
   gives, per route and size class, the launch groups and the median and
   the most problems of a group;
5b. the other entry points, each checked and its kernel launches counted
   from 0 (``[entry]`` lines): (a) the multi-process driver
   ``run_pipeline_distributed`` on the e2e genome as two processes on the
   one card (gloo over localhost, each aligner calibrated by ``devcal``
   at the fixed bulk floor of the main path's second run), aligned.bed
   and final.bed equal to the host route's; (b) ``MeshAligner``
   over the card listed twice on a mix of classes from 128 to 4,096 lanes,
   a batch of fewer than two problems a device and two problems wider
   than ``GIANT_S_T``, CIGARs equal to the single card aligner's; (c)
   ``multichip_step`` in an NCCL world of one, band bytes equal to the
   plain fill's and total == B; (d) ``classify_pair`` with every gap DP on
   the card, the CPU's class for each of 15 seeded pairs;
5c. stage 1's device engines (``[stage1]`` lines, one JSON line of them):
   the device index build on both strands of every e2e-20M chromosome
   against the host scan and the stable sort; ``search_stage(jobs=1)``
   (the whole-job path) with the roll prefilter forced on against the
   host route on both genomes, seeds.bed byte-identical, with the
   intervals planned and pruned in each phase, the composition rows, the
   device ms from dispatch to collect and both stage-1 walls; one
   ``run_pipeline(jobs=1)`` of e2e-20M under the prefilter gates
   ``devcal.apply`` installs, beds equal to the host route's; the roll
   engine forced on for the first 2 Mbp of one chromosome against itself
   and its reverse complement, seeds equal to the host route's, and one
   full batch (1,024 intervals, W 512) of each roll-length class, the
   512 class equal to the same batch's CPU run; each device op's calls,
   CUDA-event ms and bound;
5d. the main path at hg19 seed density (``[dense]`` lines): the dense
   rehearsal recipe (``sedef_tpu_torch.tools.rehearsal``) at 50 Mbp
   (``--dense-mbp``; 100 is ``tools/dense_parity.py``'s genome) on 2
   chromosomes, seed 1905, through ``run_pipeline`` (64 buckets, jobs 2)
   on the card route at the calibrated floor, then on the host route:
   seeds.bed, aligned.bed and final.bed byte-equal, ``wavefront_fill`` and
   ``backtrack_pack`` launched; both walls with their stage walls, the
   rows and seeds/Kbp beside the reference package's record at 100 Mbp
   (reported, not asserted), the card's problems, cells and launch groups,
   the widest class, peak device memory, each wrapper's launches, and the
   kernels' time (CUDA events around each launch of the card run, summed;
   with ``--profile`` the card's busy time under torch.profiler's CUDA
   activity instead);
5e. ``accuracy_table``'s per-rate classification (``[accuracy]`` lines):
   10 pairs a rate at rates 0-30 by 5, 1-20 Kbp, one process, with a card
   aligner at its calibrated floors and with a cpu one (whose stage 1
   runs on the host): the same class for every pair;
6. with ``--spread N``: N timed runs per route and genome, routes
   alternated; with ``--profile``: a ``torch.profiler`` trace of each card
   run (device busy time, kernels, copies); with ``--main-only``: phases 1,
   2, 5 and 6 alone (the walls of one tree, to set beside another's on
   the same card and host; no kernel summary and no result line).

Each kernel's bound in the summary is the larger of its integer operations
over the card's int32 peak (SMs x 64 lanes x the SM clock ``nvidia-smi``
reports as its maximum) and the bytes it must move over the HBM rate, for
the work this run's inputs need: 29 operations per band cell of a fill (23
for the checkpoint pass, which keeps no direction flags), 43 per consumed
row of a traceback; the variant kernel is held to half its fill's
operations (the 16x2 cell of ``csrc/dp_cell2.cuh`` does two lanes an
instruction), and its line also carries the one-lane and the byte bound.
No single PyTorch call computes an affine-gap
direction matrix or its traceback, so ``library_ms`` is null throughout.

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SRC_FILL = "sedef_tpu_torch/csrc/wavefront_fill.cu"
SRC_TRACE = "sedef_tpu_torch/csrc/traceback_pack.cu"
SRC_VARIANTS = "sedef_tpu_torch/csrc/wavefront_fill_variants.cu"
SRC_CLUSTER = "sedef_tpu_torch/csrc/tile_fill_cluster.cu"
REF = "sedef_tpu/ops/wavefront.py"
# kernel wrapper -> (its CUDA source, the TPU kernel it replaces)
KERNELS = {
    # its warp and owned-lane fills (the latter's kernel in fill_owned.cuh);
    # few problems of a class from 4,096 lanes on launch SRC_CLUSTER's
    "wavefront_fill": (SRC_FILL, f"{REF}:240"),
    "backtrack_pack": (SRC_TRACE, f"{REF}:387"),
    "wavefront_fill_streamed": (SRC_FILL, f"{REF}:679"),
    "tile_checkpoint": (SRC_CLUSTER, f"{REF}:849"),
    "tile_refill": (SRC_CLUSTER, f"{REF}:925"),
    "tile_backtrack": (SRC_TRACE, f"{REF}:1003"),
    "tile_checkpoint_streamed": (SRC_CLUSTER, f"{REF}:1165"),
    "tile_refill_streamed": (SRC_CLUSTER, f"{REF}:1240"),
    "tile_backtrack_streamed": (SRC_TRACE, f"{REF}:1314"),
    "wavefront_fill_variant": (SRC_VARIANTS, "tools/kbench.py:25"),
}
MAIN_PATH_KERNELS = [k for k in KERNELS if k != "wavefront_fill_variant"]

# (S_q, S_t, B) of the direct route: the classes of stage 2b's gap DPs and
# side extensions (class 128 at a small, a usual and a card-filling launch
# group), a dp_indel-sized class, one 60 Kbp chunk problem
SHAPES = [(128, 128, 32), (128, 128, 256), (128, 128, 4096),
          (256, 1024, 64), (1024, 1024, 64), (2048, 512, 64),
          (2048, 2048, 32), (8192, 8192, 2), (61440, 61440, 1)]
# (S_q, S_t, B, plan) that force every organisation of the direct fill
FORCED_FILLS = [(128, 128, 40, dict(org="warp", per_block=4)),
                (100, 90, 37, dict(org="warp", per_block=8)),
                (128, 128, 9, dict(org="owned")),
                (256, 1024, 9, dict(org="owned")),
                (2048, 512, 5, dict(org="owned")),
                (1024, 1024, 3, dict(org="owned", N=2)),
                (1024, 1024, 3, dict(org="cluster", C=1, lanes=4)),
                (1024, 1024, 3, dict(org="cluster", C=2)),
                (640, 1036, 3, dict(org="cluster", C=4)),
                (512, 2048, 2, dict(org="cluster", C=8)),
                (512, 4096, 2, dict(org="cluster", C=16))]
# (S_q, S_t, B, tile, lengths) of the walker's edge cases: walkers that
# leave on the left edge (tl << ql) and on the top edge (ql << tl), and a
# class width that is no multiple of 16 (narrower copies into the window)
WALK_EDGES = [(2048, 2048, 8, 1024, "edges"), (1024, 1036, 4, 256, "any")]
# (S_q, S_t, B) of the streamed route (more than 32 problems of a class at
# least 1 Kbp wide; the mosaic genome's regions give ~50 of 2 Kbp), K from
# the aligner's stream_k: 2, 2, 8 (the variant harness's card-filling
# batch) and 2 (the route's widest class)
STREAM_SHAPES = [(1024, 1024, 64), (2048, 2048, 50), (1024, 1024, 1056),
                 (8192, 8192, 34)]
# the streamed fill's organisations beside the card's own plan, forced
STREAM_FORCES = {"parallel owned": dict(kernel="owned"),
                 "parallel cluster": dict(kernel="cluster"),
                 "chain": dict(org="chain")}
# (S_q, S_t, B) of the tiled route: the mosaic genome's 10 Kbp dp_indel
# class, alone (<= 8 problems) and streamed (> 8), the narrowest giant
# class the route rule produces ((S_q + S_t) * S_t > 2^27), and one 60 Kbp
# chunk
TILED_SHAPES = [(10240, 10240, 4), (10240, 10240, 16), (30720, 4096, 4),
                (61440, 61440, 1)]
NUMPY_CHECK_MAX = 10240  # CIGARs vs NumPy only up to this class width
PLAIN_TILES_MAX = 10     # plain refill / walk on every tile up to this many
NUMPY_CHECK_N = 4
# shape whose times go into the kernel summary, per kernel
SUMMARY_AT = {"wavefront_fill": (1024, 1024, 64),
              "wavefront_fill_variant": (1024, 1024, 64),
              "backtrack_pack": (1024, 1024, 64),
              "wavefront_fill_streamed": (2048, 2048, 50)}
for _k in ("tile_checkpoint", "tile_refill", "tile_backtrack"):
    SUMMARY_AT[_k] = (10240, 10240, 4)
    SUMMARY_AT[_k + "_streamed"] = (10240, 10240, 16)

# integer operations per band cell of a fill (6 score, 17 recurrence, 6
# direction flags: csrc/dp_cell.cuh's cell), of the checkpoint pass
# (no direction flags), and per consumed row of a traceback
# (csrc/traceback_pack.cu's walk loop)
OPS_FILL, OPS_CKPT, OPS_WALK = 29, 23, 43
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet)
PEAKS = {}  # "int32_ops_per_s", set by phase_device


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take for ``ops`` int32 operations
    and ``nbytes`` bytes moved, and which of the two sets it."""
    t_ops = ops / PEAKS["int32_ops_per_s"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def band_cells(S_q: int, S_t: int, K: int, r0: int, r1: int) -> int:
    """Band cells of stream rows [r0, r1) of one K-problem stream."""
    import numpy as np
    r = np.arange(r0, r1, dtype=np.int64)
    width = np.minimum(r, S_t - 1) - np.maximum(0, r - K * S_q + 1) + 1
    return int(width.clip(min=0).sum())


def consumed_rows(packed) -> int:
    """Anti-diagonal rows the walkers consumed: 2-bit fields that are not
    3 in a packed-op tensor."""
    o = packed.int()
    return sum(int((((o >> sh) & 3) != 3).sum()) for sh in (0, 2, 4, 6))


def smi(query, *fmt) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader" + "".join(fmt)], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    log(smi("name,power.limit"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm", ",nounits"))
    PEAKS["int32_ops_per_s"] = sms * INT32_LANES_PER_SM * mhz * 1e6
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}; {sms} SMs x "
        f"{INT32_LANES_PER_SM} int32 lanes x {mhz:.0f} MHz = "
        f"{PEAKS['int32_ops_per_s'] / 1e12:.3f} Top/s int32 peak, HBM "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")


def phase_build():
    from sedef_tpu_torch.native.build import build_cuda, build_native
    from sedef_tpu_torch.ops import wavefront as wf
    # g++ and the nvcc compiles (one per source) run side by side
    from concurrent.futures import ThreadPoolExecutor
    took = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        took[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(timed, "native",
                            lambda: build_native(force=True)),
                pool.submit(timed, "cuda",
                            lambda: build_cuda(verbose=True, force=True))]
        for job in jobs:
            job.result()
    wf._kernels()
    log(f"[build] native {took['native']:.2f}s cuda {took['cuda']:.2f}s, "
        f"together {time.perf_counter() - t0:.2f}s")


def _random_class(rng, S_q, S_t, B):
    """B random problems of one class: true lengths in the upper half of
    the class, targets copied from the query with 10% substitutions (and
    a random tail where tl > ql) so alignments are non-trivial, 2%
    wildcards in the query."""
    import numpy as np
    qs = np.full((B, S_q), 4, np.int8)
    ts = np.full((B, S_t), 4, np.int8)
    ql = rng.integers(max(1, S_q // 2), S_q + 1, B).astype(np.int32)
    tl = rng.integers(max(1, S_t // 2), S_t + 1, B).astype(np.int32)
    for b in range(B):
        q = rng.integers(0, 4, ql[b]).astype(np.int8)
        n = min(ql[b], tl[b])
        t = np.concatenate([q[:n], rng.integers(0, 4, tl[b] - n)])
        t = t.astype(np.int8)
        mut = rng.random(tl[b]) < 0.10
        t[mut] = rng.integers(0, 4, int(mut.sum()))
        q[rng.random(ql[b]) < 0.02] = 4
        qs[b, :ql[b]] = q
        ts[b, :tl[b]] = t
    return qs, ts, ql, tl


def _band_diff(pa, pb, r0, S_q, S_t, K, row_chunk=4096):
    """(mismatching bytes, max |a - b|) of two (n_streams, rows, S_t)
    direction blocks starting at stream row r0, on every written lane."""
    from sedef_tpu_torch.ops.wavefront import stream_band
    bad = worst = 0
    for c0 in range(0, pa.shape[1], row_chunk):
        c1 = min(c0 + row_chunk, pa.shape[1])
        m = stream_band(r0 + c0, r0 + c1, S_q, S_t, K, pa.device)
        d = (pa[:, c0:c1].int() - pb[:, c0:c1].int()).abs() * m
        bad += int((d > 0).sum())
        worst = max(worst, int(d.max()))
    return bad, worst


def _require(bad: int, what: str) -> None:
    if bad:
        raise AssertionError(f"{what}: {bad} mismatches against the plain "
                             f"version")


class _Timer:
    """CUDA-event time of kernel launches (``kernel``) and host time of
    plain-version calls ending in a synchronize (``plain``): their sum
    (``ms``), mean, and median (``typical``: repeated launches of one
    shape, where one slow launch should not set the number)."""

    def __init__(self):
        self.ms = 0.0
        self.n = 0
        self.samples = []

    def kernel(self, fn):
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        self._add(start.elapsed_time(end))
        return out

    def plain(self, fn):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self._add((time.perf_counter() - t0) * 1e3)
        return out

    def _add(self, ms: float) -> None:
        self.ms += ms
        self.n += 1
        self.samples.append(ms)

    @property
    def mean(self) -> float:
        return self.ms / max(self.n, 1)

    @property
    def typical(self) -> float:
        import statistics
        return statistics.median(self.samples)


def _check_cigars(wf, qs, ts, ql, tl, ops, n, label):
    for b in range(n):
        qq, tt = qs[b, :ql[b]], ts[b, :tl[b]]
        p_np, _ = wf.wavefront_np(qq, tt)
        want = wf.backtrack_np(p_np, len(qq), len(tt))
        if wf.cigar_from_packed_ops(ops[b], len(qq), len(tt)) != want:
            raise AssertionError(f"CIGAR {label} problem {b} differs from "
                                 f"the NumPy reference")


class KernelPhase:
    """Phase 3: each kernel wrapper on the card against its plain version
    on the same inputs; ``self.summary`` holds, per wrapper, the largest
    byte difference seen and the times at its SUMMARY_AT shape."""

    def __init__(self):
        import numpy as np
        import torch

        from sedef_tpu_torch.ops import wavefront as wf
        self.np, self.torch, self.wf = np, torch, wf
        self.dev = torch.device("cuda", 0)
        self.rng = np.random.default_rng(2024)
        self.summary = {name: {"max_abs_err": 0, "library_ms": None}
                        for name in KERNELS}
        # shape -> (inputs, plain checkpoints, ms of the plain pass): a
        # direct shape that the tiled route takes too runs its plain fill
        # once, for both
        self.shared = {}

    def _record(self, name, shape, worst, ms, plain_ms, ops, nbytes):
        """``ops`` / ``nbytes``: what one launch must do on these inputs
        (integer operations, bytes moved), for the bound."""
        rec = self.summary[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], worst)
        if SUMMARY_AT[name] == shape:
            rec.update(ms=ms, plain_ms=plain_ms, **bound(ops, nbytes),
                       at="S_q={},S_t={},B={}".format(*shape))

    def _inputs(self, S_q, S_t, B):
        qs, ts, ql, tl = _random_class(self.rng, S_q, S_t, B)
        dev = self.dev
        t = [self.torch.from_numpy(a).to(dev) for a in (qs, ts, ql, tl)]
        return (qs, ts, ql, tl), t

    def run(self):
        wf, torch = self.wf, self.torch
        # warm the context, the allocator and the plain versions
        _, (q, t, ql, tl) = self._inputs(128, 128, 2)
        wf.backtrack_pack_torch(wf.wavefront_fill_torch(q, t), ql, tl)
        def each(fn, shapes):
            for x in shapes:
                fn(*x)
                torch.cuda.empty_cache()

        parts = [("direct", lambda: each(self.direct, SHAPES)),
                 ("organisations", self.organisations),
                 ("walk edges", self.walk_edges),
                 ("variants", self.variants),
                 ("streamed", lambda: each(self.streamed, STREAM_SHAPES)),
                 ("tiled", lambda: each(self.tiled, TILED_SHAPES))]
        took = {}
        for name, part in parts:
            t0 = time.perf_counter()
            part()
            torch.cuda.empty_cache()
            took[name] = round(time.perf_counter() - t0, 1)
        log(f"[kernels] phase took (s): {took}")
        return self.summary

    def direct(self, S_q, S_t, B):
        wf, np = self.wf, self.np
        (qs, ts, ql, tl), (q, t, qlt, tlt) = self._inputs(S_q, S_t, B)
        fk, fp, tk, tp = _Timer(), _Timer(), _Timer(), _Timer()
        reps = 9 if S_t <= 2048 else 1
        plan = wf.fill_plan_on(self.dev, S_q, S_t, B)
        wf.wavefront_fill(q, t)  # the first, cold launch is not timed
        for _ in range(reps):
            p_k = fk.kernel(lambda: wf.wavefront_fill(q, t))
        if (S_q, S_t, B) in TILED_SHAPES:
            # one plain pass gives the direction matrix and the tiled
            # route's checkpoints
            [(_, K, tile)] = wf.WavefrontAligner(device=self.dev).tiled_parts(
                list(range(B)), S_q, S_t)
            p_p = self.torch.empty_like(p_k)
            ck_p = fp.plain(lambda: wf.tile_checkpoint_torch(q, t, tile, K,
                                                             p_out=p_p))
            self.shared[S_q, S_t, B] = ((qs, ts, ql, tl), (q, t, qlt, tlt),
                                        ck_p, fp.mean)
        else:
            p_p = fp.plain(lambda: wf.wavefront_fill_torch(q, t))
        bad, worst = _band_diff(p_k, p_p, 0, S_q, S_t, 1)
        _require(bad, f"fill ({S_q},{S_t})")
        del p_p
        wf.backtrack_pack(p_k, qlt, tlt)
        for _ in range(reps):
            o_k = tk.kernel(lambda: wf.backtrack_pack(p_k, qlt, tlt))
        o_p = tp.plain(lambda: wf.backtrack_pack_torch(p_k, qlt, tlt))
        _require(int((o_k != o_p).sum()), f"traceback ({S_q},{S_t})")
        trace_err = int((o_k.int() - o_p.int()).abs().max())
        n_np = NUMPY_CHECK_N if max(S_q, S_t) <= 2048 else 0
        _check_cigars(wf, qs, ts, ql, tl, o_k.cpu().numpy(), n_np,
                      f"({S_q},{S_t})")
        cells = int((ql.astype(np.int64) * tl).sum())
        log(f"[kernels] direct ({S_q},{S_t}) B={B}: plan {plan.org} "
            f"C={plan.C} W={plan.W} lanes={plan.lanes} "
            f"per_block={plan.per_block}; fill {fk.typical:.3f} ms "
            f"(plain {fp.mean:.1f} ms, {cells / fk.typical / 1e6:.2f} GCUPS)"
            f", traceback {tk.typical:.3f} ms (plain {tp.mean:.1f} ms); 0 "
            f"byte mismatches; {n_np} CIGARs = NumPy")
        steps = consumed_rows(o_k)
        self._record("wavefront_fill", (S_q, S_t, B), worst, fk.typical,
                     fp.mean, OPS_FILL * B * S_q * S_t,
                     B * (S_q + S_t) + B * S_q * S_t)
        self._record("backtrack_pack", (S_q, S_t, B), trace_err, tk.typical,
                     tp.mean, OPS_WALK * steps,
                     steps + o_k.numel() + 8 * B)
        if (S_q, S_t, B) == SUMMARY_AT["wavefront_fill"]:
            # the same problems on the native scalar DP (host CPU), the
            # route stragglers take
            from sedef_tpu_torch.native import lib as nlib
            pairs = [(qs[b, :ql[b]].astype(np.uint8),
                      ts[b, :tl[b]].astype(np.uint8)) for b in range(B)]
            t0 = time.perf_counter()
            nlib.align_batch(pairs, 5, -4, 40, 1)
            native_ms = (time.perf_counter() - t0) * 1e3
            log(f"[kernels] direct ({S_q},{S_t}) B={B}: native scalar DP "
                f"on the host {native_ms:.1f} ms "
                f"({cells / native_ms / 1e6:.3f} GCUPS)")

    def organisations(self):
        """Every organisation ``fill_plan`` can choose, forced, against
        the plain fill on every band lane."""
        wf, torch = self.wf, self.torch
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        seen = set()
        for S_q, S_t, B, force in FORCED_FILLS:
            _, (q, t, _, _) = self._inputs(S_q, S_t, B)
            plan = wf.fill_plan(S_q, S_t, B, sms, **force)
            got = wf.wavefront_fill(q, t, plan=plan)
            torch.cuda.synchronize()
            bad, worst = _band_diff(got, wf.wavefront_fill_torch(q, t), 0,
                                    S_q, S_t, 1)
            _require(bad, f"fill ({S_q},{S_t}) under {plan}")
            self.summary["wavefront_fill"]["max_abs_err"] = max(
                self.summary["wavefront_fill"]["max_abs_err"], worst)
            seen.add(plan.org)
            log(f"[kernels] forced ({S_q},{S_t}) B={B}: {plan.org} "
                f"C={plan.C} W={plan.W} lanes={plan.lanes} N={plan.N} "
                f"per_block={plan.per_block}; 0 byte mismatches")
        if seen != set(wf.FILL_ORGS):
            raise AssertionError(f"forced fills reached {sorted(seen)} of "
                                 f"{wf.FILL_ORGS}")

    def walk_edges(self):
        """The walker under every walk plan, tile by tile, against the
        plain tile walk, and the whole matrix against the plain
        traceback."""
        wf, torch = self.wf, self.torch
        from sedef_tpu_torch.tools import kbench
        for S_q, S_t, B, tile, lengths in WALK_EDGES:
            qs, ts, ql, tl = _random_class(self.rng, S_q, S_t, B)
            if lengths == "edges":  # half leave on the left, half on top
                tl[0::2] = self.rng.integers(1, 40, len(tl[0::2]))
                ql[1::2] = self.rng.integers(1, 40, len(ql[1::2]))
                for b in range(B):
                    qs[b, ql[b]:] = 4
                    ts[b, tl[b]:] = 4
            q, t, qlt, tlt = (torch.from_numpy(a).to(self.dev)
                              for a in (qs, ts, ql, tl))
            p = wf.wavefront_fill(q, t)
            want = wf.backtrack_pack_torch(p, qlt, tlt)
            n_rows = p.shape[1]
            n_tiles = -(-n_rows // tile)
            plans = kbench.walk_plans(B, 132)

            def tiles():
                for ti in range(n_tiles - 1, -1, -1):
                    pt = torch.zeros((B, tile, S_t), dtype=torch.uint8,
                                     device=self.dev)
                    rows = min(tile, n_rows - ti * tile)
                    pt[:, :rows] = p[:, ti * tile:ti * tile + rows]
                    yield ti, pt

            def walkers():
                return (torch.stack([tlt - 1, qlt - 1,
                                     torch.zeros_like(qlt)], 1),
                        torch.zeros_like(want))

            # the plain walk once: walker states and bytes after every tile
            ws_p, out_p = walkers()
            after = {}
            for ti, pt in tiles():
                wf.tile_backtrack_torch(pt, qlt, tlt, ws_p, out_p, ti * tile,
                                        S_q)
                after[ti] = (ws_p.clone(), out_p.clone())
            _require(int((out_p != want).sum()),
                     f"plain tiled ops ({S_q},{S_t})")
            for plan in plans.values():
                got = wf.backtrack_pack(p, qlt, tlt, plan=plan)
                _require(int((got != want).sum()),
                         f"traceback ({S_q},{S_t}) under {plan}")
                ws_k, out_k = walkers()
                for ti, pt in tiles():
                    wf.tile_backtrack(pt, qlt, tlt, ws_k, out_k, ti * tile,
                                      S_q, plan=plan)
                    _require(int((ws_k != after[ti][0]).sum())
                             + int((out_k != after[ti][1]).sum()),
                             f"tile walk ({S_q},{S_t}) tile {ti} under "
                             f"{plan}")
            _check_cigars(wf, qs, ts, ql, tl, want.cpu().numpy(),
                          min(B, NUMPY_CHECK_N), f"edges ({S_q},{S_t})")
            log(f"[kernels] walker ({S_q},{S_t}) B={B} tile={tile} "
                f"{lengths}: {len(plans)} walk plans "
                f"({', '.join(plans)}); 0 mismatches in packed ops and "
                f"walker states, whole matrix and {n_tiles} tiles")

    def streamed(self, S_q, S_t, B):
        """The streamed fill at one shape under the card's own plan (timed)
        and under every organisation of STREAM_FORCES, each against the
        plain streamed fill on every band lane; its traceback against the
        plain one and against the direct route's ops."""
        wf, np, torch = self.wf, self.np, self.torch
        K = wf.WavefrontAligner(device=self.dev).stream_k(B)
        n = B // K
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        (qs, ts, ql, tl), (q, t, qlt, tlt) = self._inputs(S_q, S_t, B)
        fk, fp, tk, tp, dk = (_Timer() for _ in range(5))
        own = wf.stream_plan_on(self.dev, S_q, S_t, n, K)
        wf.wavefront_fill_streamed(q, t, K)
        p_d = wf.wavefront_fill(q, t)
        for _ in range(5):
            p_k = fk.kernel(lambda: wf.wavefront_fill_streamed(q, t, K))
            p_d = dk.kernel(lambda: wf.wavefront_fill(q, t))
        p_p = fp.plain(lambda: wf.wavefront_fill_streamed_torch(q, t, K))
        bad, worst = _band_diff(p_k, p_p, 0, S_q, S_t, K)
        _require(bad, f"streamed fill ({S_q},{S_t},K={K}) under {own}")
        plans = {"own": own}
        forced = []
        for label, force in STREAM_FORCES.items():
            try:
                plan = wf.stream_plan(S_q, S_t, n, K, sms, **force)
            except ValueError:
                forced.append(f"{label}: not taken by the class")
                continue
            plans[label] = plan
            wf.wavefront_fill_streamed(q, t, K, plan=plan)  # not timed
            ms = _Timer()
            got = ms.kernel(
                lambda: wf.wavefront_fill_streamed(q, t, K, plan=plan))
            b2, w2 = _band_diff(got, p_p, 0, S_q, S_t, K)
            _require(b2, f"streamed fill ({S_q},{S_t},K={K}) under {plan}")
            worst = max(worst, w2)
            f = plan.fill
            forced.append(f"{label} ({f.org} C={f.C} W={f.W} "
                          f"lanes={f.lanes} N={f.N}) {ms.mean:.3f} ms")
            del got
        del p_p, p_d
        wf.backtrack_pack(p_k, qlt, tlt, K)
        for _ in range(3):
            o_k = tk.kernel(lambda: wf.backtrack_pack(p_k, qlt, tlt, K))
        o_p = tp.plain(lambda: wf.backtrack_pack_torch(p_k, qlt, tlt, K))
        _require(int((o_k != o_p).sum()), f"streamed traceback ({S_q},"
                 f"{S_t},K={K})")
        direct = wf.backtrack_pack(wf.wavefront_fill(q, t), qlt, tlt)
        _require(int((o_k != direct).sum()), "streamed vs direct ops")
        n_np = NUMPY_CHECK_N if max(S_q, S_t) <= 2048 else 0
        _check_cigars(wf, qs, ts, ql, tl, o_k.cpu().numpy(), n_np,
                      f"streamed ({S_q},{S_t})")
        cells = int((ql.astype(np.int64) * tl).sum())
        f = own.fill
        log(f"[kernels] streamed ({S_q},{S_t}) B={B} K={K}: plan {own.org} "
            f"{f.org} C={f.C} W={f.W} lanes={f.lanes} N={f.N}; fill "
            f"{fk.typical:.3f} ms (plain {fp.mean:.1f} ms, "
            f"{cells / fk.typical / 1e6:.2f} GCUPS; direct fill of the same "
            f"batch {dk.typical:.3f} ms), p {p_k.numel()} bytes (direct "
            f"{B * (S_q + S_t - 1) * S_t}); forced: {'; '.join(forced)}; "
            f"traceback {tk.typical:.3f} ms (plain {tp.mean:.1f} ms); 0 band "
            f"byte mismatches under {len(plans)} plans against the plain, "
            f"ops = plain and direct route's; {n_np} CIGARs = NumPy")
        self._record("wavefront_fill_streamed", (S_q, S_t, B), worst,
                     fk.typical, fp.mean, OPS_FILL * B * S_q * S_t,
                     B * (S_q + S_t) + B * S_q * S_t)

    def variants(self):
        """Every fill variant against the plain fill (0 mismatching band
        bytes; the harness's own CIGAR check of each runs on the calibration
        path) on the harness's golden problem and at every shape of
        ``kbench.VARIANT_SHAPES`` it takes, then timed there beside kernel
        1, each time against three bounds: 29 int32 operations a band cell
        (one lane an instruction), the same two lanes an instruction (the
        16x2 cell of ``csrc/dp_cell2.cuh``), and the band's direction bytes
        over the HBM rate; and the SASS instructions of the row bodies."""
        wf, torch = self.wf, self.torch
        from sedef_tpu_torch.tools import kbench
        qseq, tgt, _, _ = kbench.golden_problem()
        gq = torch.from_numpy(qseq).to(self.dev)
        gt = torch.from_numpy(tgt).to(self.dev)
        want = wf.wavefront_fill_torch(gq, gt)
        for v in wf.FILL_VARIANTS:
            got = wf.wavefront_fill_variant(v, gq, gt)
            torch.cuda.synchronize()
            _require(kbench.band_mismatches(got, want, 128, 128),
                     f"fill variant {v} (128,128) golden")
        summary = SUMMARY_AT["wavefront_fill_variant"]
        plain = _Timer()
        taken = {}
        for shape in kbench.VARIANT_SHAPES:
            S_q, S_t, B = shape
            _, (q, t, _, _) = self._inputs(S_q, S_t, B)
            timer = plain if shape == summary else _Timer()
            want = timer.plain(lambda: wf.wavefront_fill_torch(q, t))
            taken[shape] = [v for v in wf.FILL_VARIANTS
                            if kbench.variant_takes(v, S_t)]
            for v in taken[shape]:
                got = wf.wavefront_fill_variant(v, q, t)
                torch.cuda.synchronize()
                _require(kbench.band_mismatches(got, want, S_q, S_t),
                         f"fill variant {v} ({S_q},{S_t},{B})")
                del got
            del want, q, t
            torch.cuda.empty_cache()
            left = sorted(set(wf.FILL_VARIANTS) - set(taken[shape]))
            log(f"[variants] ({S_q},{S_t},{B}): {len(taken[shape])} "
                f"variants, 0 band mismatches against the plain fill; not "
                f"taken: {', '.join(left) or 'none'}")
        table = kbench.bench_variants(wf.FILL_VARIANTS, self.dev)
        bounds = {}
        for (S_q, S_t, B), ms in table.items():
            cells = B * S_q * S_t
            nbytes = B * (S_q + S_t) + cells
            b1 = bound(OPS_FILL * cells, nbytes)
            b2 = bound(OPS_FILL * cells / 2, nbytes)
            bb = nbytes / HBM_BYTES_PER_S * 1e3
            bounds[S_q, S_t, B] = (b1, b2, bb)
            log(f"[variants] bounds ({S_q},{S_t},{B}): one lane an "
                f"instruction {b1['bound_ms']:.4f} ms, two lanes an "
                f"instruction {b2['bound_ms']:.4f} ms, bytes {bb:.4f} ms")
            for v in ("wavefront_fill",) + wf.FILL_VARIANTS:
                if v not in ms:
                    log(f"[variants] {v:14s} ({S_q},{S_t},{B}): not taken")
                    continue
                log(f"[variants] {v:14s} ({S_q},{S_t},{B}): "
                    f"{ms[v]:.4f} ms {cells / ms[v] / 1e6:.2f} GCUPS; "
                    f"{b1['bound_ms'] / ms[v]:.1%} of the one-lane bound, "
                    f"{b2['bound_ms'] / ms[v]:.1%} of the two-lane bound, "
                    f"{bb / ms[v]:.1%} of the byte bound")
        sass = kbench.sass_counts()
        log("[variants] sass " + json.dumps(sass))
        small = table[summary]
        best = min((v for v in wf.FILL_VARIANTS if v in small),
                   key=lambda v: small[v])
        S_q, S_t, B = summary
        # held to the two-lanes-an-instruction bound: the 16x2 cell does a
        # band cell's 29 operations in half the instructions
        self._record("wavefront_fill_variant", summary, 0, small[best],
                     plain.mean, OPS_FILL * B * S_q * S_t / 2,
                     B * (S_q + S_t) + B * S_q * S_t)
        self.summary["wavefront_fill_variant"].update(
            variant=best,
            bound_one_lane_ms=bounds[summary][0]["bound_ms"],
            bound_bytes_ms=bounds[summary][2],
            fastest={"S_q={},S_t={},B={}".format(*shape): min(
                (v for v in wf.FILL_VARIANTS if v in ms),
                key=lambda v: ms[v]) for shape, ms in table.items()},
            variants_ms={"S_q={},S_t={},B={}".format(*shape): ms
                         for shape, ms in table.items()},
            sass=sass)

    def tiled(self, S_q, S_t, B):
        wf, torch = self.wf, self.torch
        al = wf.WavefrontAligner(device=self.dev)
        [(_, K, tile)] = al.tiled_parts(list(range(B)), S_q, S_t)
        streamed = K > 1
        sfx = "_streamed" if streamed else ""
        names = [n + sfx for n in ("tile_checkpoint", "tile_refill",
                                   "tile_backtrack")]
        ckpt_fn, refill_fn, walk_fn = (getattr(wf, n) for n in names)
        shared = self.shared.pop((S_q, S_t, B), None)
        if shared:
            (qs, ts, ql, tl), (q, t, qlt, tlt), ck_p, plain_ms = shared
        else:
            (qs, ts, ql, tl), (q, t, qlt, tlt) = self._inputs(S_q, S_t, B)
        kargs = (K, tile) if streamed else (tile,)
        timers = {n: (_Timer(), _Timer()) for n in names}
        plan = wf.tile_plan_on(self.dev, S_t, B // K, False)
        held = [wf.tile_cluster_occupancy(plan, B // K, refill, self.dev)
                for refill in (False, True)]
        wplan = wf.walk_plan(B, torch.cuda.get_device_properties(
            self.dev).multi_processor_count)
        plan_note = (f" walkers R={wplan.R} pw={wplan.pw} "
                     f"prefetch={wplan.prefetch} warps={wplan.warps};"
                     f" {B // K} clusters of C={plan.C} W={plan.W} "
                     f"lanes={plan.lanes} N={plan.N} ring={plan.ring} "
                     f"smem={plan.smem_bytes} B,"
                     f" max active clusters {held[0]} (checkpoint) / "
                     f"{held[1]} (refill);")
        ckpt_fn(q, t, *kargs)  # the first, cold launch is not timed
        for _ in range(3):
            ck_k = timers[names[0]][0].kernel(lambda: ckpt_fn(q, t, *kargs))
        if shared:
            timers[names[0]][1]._add(plain_ms)
        else:
            ck_p = timers[names[0]][1].plain(
                lambda: wf.tile_checkpoint_torch(q, t, tile, K))
        ck_bad = ck_worst = 0
        for ti in range(1, ck_k.shape[1]):
            m = wf.stream_band(ti * tile - 1, ti * tile, S_q, S_t, K,
                               self.dev)[0]
            d = (ck_k[:, ti][:, :, m] - ck_p[:, ti][:, :, m]).abs()
            ck_bad += int((d > 0).sum())
            ck_worst = max(ck_worst, int(d.max()) if d.numel() else 0)
        _require(ck_bad, f"{names[0]} ({S_q},{S_t})")
        del ck_p
        n_rows = K * S_q + S_t - 1
        ws_k = torch.stack([tlt - 1, qlt - 1, torch.zeros_like(qlt)], 1)
        ws_p = ws_k.clone()
        n_bytes = (S_q + S_t - 1 + 3) // 4
        out_k = torch.empty((B, n_bytes), dtype=torch.uint8, device=self.dev)
        out_p = out_k.clone()
        fill_worst = walk_bad = 0
        refill_fn(q, t, ck_k, *((0, K, tile) if streamed else (0, tile)))
        n_tiles = ck_k.shape[1]
        # past PLAIN_TILES_MAX tiles the plain versions run on every third
        # tile and on the first and the last; the kernels run on all, and
        # the route's packed ops are held against the direct route's below
        stride = 1 if n_tiles <= PLAIN_TILES_MAX else 3
        for ti in range(n_tiles - 1, -1, -1):
            r0 = ti * tile
            rargs = (ti, K, tile) if streamed else (ti, tile)
            wargs = (r0, S_q, K) if streamed else (r0, S_q)
            pt_k = timers[names[1]][0].kernel(
                lambda: refill_fn(q, t, ck_k, *rargs))
            if ti % stride and ti != n_tiles - 1:
                timers[names[2]][0].kernel(
                    lambda: walk_fn(pt_k, qlt, tlt, ws_k, out_k, *wargs))
                ws_p.copy_(ws_k)
                out_p.copy_(out_k)
                continue
            pt_p = timers[names[1]][1].plain(
                lambda: wf.tile_refill_torch(q, t, ck_k, ti, tile, K))
            rows = min(tile, n_rows - r0)
            bad, worst = _band_diff(pt_k[:, :rows], pt_p[:, :rows], r0, S_q,
                                    S_t, K)
            _require(bad, f"{names[1]} ({S_q},{S_t}) tile {ti}")
            fill_worst = max(fill_worst, worst)
            del pt_p
            timers[names[2]][0].kernel(
                lambda: walk_fn(pt_k, qlt, tlt, ws_k, out_k, *wargs))
            timers[names[2]][1].plain(
                lambda: wf.tile_backtrack_torch(pt_k, qlt, tlt, ws_p, out_p,
                                                r0, S_q, K))
            walk_bad += int((ws_k != ws_p).sum()) + int((out_k
                                                         != out_p).sum())
            _require(walk_bad, f"{names[2]} ({S_q},{S_t}) tile {ti}")
        del pt_k, ck_k
        dk = _Timer()
        p_direct = dk.kernel(lambda: wf.wavefront_fill(q, t))
        direct = wf.backtrack_pack(p_direct, qlt, tlt)
        _require(int((out_k != direct).sum()), f"tiled ({S_q},{S_t}) vs "
                 f"direct ops")
        del direct, p_direct
        n_np = 1 if max(S_q, S_t) <= NUMPY_CHECK_MAX else 0
        _check_cigars(wf, qs, ts, ql, tl, out_k.cpu().numpy(), n_np,
                      f"tiled ({S_q},{S_t})")
        parts = ", ".join(
            f"{n} {timers[n][0].mean:.3f} ms x{timers[n][0].n} (plain "
            f"{timers[n][1].mean:.1f} ms x{timers[n][1].n})" for n in names)
        total = timers[names[0]][0].mean + sum(timers[n][0].ms
                                                for n in names[1:])
        log(f"[kernels] tiled ({S_q},{S_t}) B={B} K={K} tile={tile}:"
            f"{plan_note} {parts}; route total {total:.3f} ms (direct "
            f"fill of the same batch {dk.mean:.3f} ms); 0 mismatches, ops "
            f"= direct route's; {n_np} CIGARs = NumPy")
        # work per launch: the checkpoint pass does the whole fill once;
        # a refill or a walk does, on average, one tile's share of it
        n = B // K
        cells = n * K * S_q * S_t
        codes = B * (S_q + S_t)
        steps = consumed_rows(out_k)
        work = ((OPS_CKPT * cells, codes + 16 * S_t * n * n_tiles),
                (OPS_FILL * cells / n_tiles,
                 16 * S_t * n + (codes + cells) / n_tiles),
                (OPS_WALK * steps / n_tiles,
                 (steps + out_k.numel()) / n_tiles + 32 * B))
        for nm, worst, (ops, nbytes) in zip(names, (ck_worst, fill_worst, 0),
                                            work):
            self._record(nm, (S_q, S_t, B), worst, timers[nm][0].mean,
                         timers[nm][1].mean, ops, nbytes)


# ---------------------------------------------------------------------------
# Phase 4: the calibration path
# ---------------------------------------------------------------------------

def _zero_counts():
    from sedef_tpu_torch.ops import wavefront as wf
    for w in wf.KERNEL_WRAPPERS:
        w.launches = 0


def _read_counts() -> dict:
    from sedef_tpu_torch.ops import wavefront as wf
    return {w.__name__: w.launches for w in wf.KERNEL_WRAPPERS}


def _floor_crossover(al):
    """One launch group on the card against the native scalar DP on the
    host, for n problems of the smallest class: [(n, cells, card ms, host
    ms)], medians of 5.  The batch floor the calibration derives should
    lie where the two cross."""
    import statistics

    import numpy as np

    from sedef_tpu_torch.native import lib as nlib
    rng = np.random.default_rng(5)
    rows = []
    for n in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
        pairs = [(rng.integers(0, 4, int(a)).astype(np.int8),
                  rng.integers(0, 4, int(b)).astype(np.int8))
                 for a, b in rng.integers(96, 129, (n, 2))]
        host_pairs = [(q.astype(np.uint8), t.astype(np.uint8))
                      for q, t in pairs]
        part = list(range(n))
        card, host = [], []
        al._solve(pairs, part, 128, 128, 1, None)
        for _ in range(5):
            t0 = time.perf_counter()
            al._solve(pairs, part, 128, 128, 1, None)
            card.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            nlib.align_batch(host_pairs, 5, -4, 40, 1)
            host.append((time.perf_counter() - t0) * 1e3)
        rows.append((n, sum(len(q) * len(t) for q, t in pairs),
                     statistics.median(card), statistics.median(host)))
    return rows


def phase_calibration():
    """The variant harness and the dispatch calibration, through their
    entry points; returns the launches they made, per wrapper."""
    from sedef_tpu_torch import devcal
    from sedef_tpu_torch.ops import wavefront as wf
    from sedef_tpu_torch.tools import kbench
    _zero_counts()
    if kbench.main(["--device", "cuda"]):
        raise AssertionError("the variant harness reported a wrong variant")
    al = wf.WavefrontAligner(device="cuda")
    applied = devcal.apply(al)
    counts = _read_counts()
    cal = devcal.get()
    if not (cal.measured and applied["calibrated"]
            and al.DEVICE_BATCH_MIN_CELLS == cal.device_batch_min_cells
            and al.DEVICE_BATCH_MIN == cal.device_batch_min):
        raise AssertionError(f"devcal did not install measured floors: "
                             f"{applied}")
    cross = _floor_crossover(al)
    first = next((n for n, _, card, host in cross if card < host), None)
    log("[devcal] " + json.dumps({
        **applied, "floors": list(devcal.CARD_FLOORS),
        "frozen": [wf.FROZEN_BATCH_MIN_CELLS, wf.FROZEN_BATCH_MIN],
        "crossover_class128": [
            {"problems": n, "cells": c, "card_ms": round(a, 4),
             "host_ms": round(b, 4)} for n, c, a, b in cross],
        "card_faster_from_problems": first}))
    for name in ("wavefront_fill_variant", "wavefront_fill",
                 "backtrack_pack", "wavefront_fill_streamed"):
        if counts[name] <= 0:
            raise AssertionError(f"calibration path launched no {name}")
    log(f"[calibration] launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# Phase 5: the main path
# ---------------------------------------------------------------------------

GENOME_BP = 20_000_000
JOBS = 2
# bench.py's end-to-end spec (bench.py:62-63)
E2E_SPEC = dict(n_sds=20, seed=7, n_chroms=4, repeat_families=20,
                repeat_copies=40)
# the mosaic-SD genome: the same background and repeat families, 30
# planted SDs of 120-200 Kbp whose copies carry diverged cores (see
# mosaic_genome)
MOSAIC_SPEC = dict(n_sds=30, seed=7, n_chroms=4, repeat_families=20,
                   repeat_copies=40, sd_min=120_000, sd_max=200_000)
# a fixed bulk-batch floor beside the calibrated one (set on the aligner
# instance, which ``devcal.apply`` then leaves alone), so that runs on
# different cards put the same problems on the card
LOW_FLOOR = 1 << 18


def mosaic_genome():
    """A 20 Mbp genome whose SDs are mosaics: in each forward SD, cores
    are re-randomised independently in both copies (diverged duplicon
    blocks, as in primate SD mosaics), 8.4-9.6 Kbp cores between 1.8-2.6
    Kbp conserved blocks in even SDs, 1.1-1.9 Kbp cores between 1.2-1.6
    Kbp blocks in odd ones.  Alignment chains then bridge multi-Kbp double
    gaps: the dp_indel gap DPs of the 2 Kbp and 10 Kbp classes."""
    import numpy as np

    from sedef_tpu_torch.models.genome_sim import simulate_genome
    chroms, planted = simulate_genome(GENOME_BP, **MOSAIC_SPEC)
    rng = np.random.default_rng(3)
    bufs = {n: bytearray(s, "ascii") for n, s in chroms.items()}
    up = np.frombuffer(b"ACGT", np.uint8)
    for si, sd in enumerate(planted):
        if sd.is_rc:
            continue
        core, keep = (((8400, 9600), (1800, 2600)) if si % 2 == 0
                      else ((1100, 1900), (1200, 1600)))
        span = min(sd.a_end - sd.a_start, sd.b_end - sd.b_start)
        pos = int(rng.integers(*keep))
        while True:
            ln = int(rng.integers(*core))
            if pos + ln + keep[1] > span:
                break
            for name, st in ((sd.chrom_a, sd.a_start),
                             (sd.chrom_b, sd.b_start)):
                bufs[name][st + pos:st + pos + ln] = \
                    up[rng.integers(0, 4, ln)].tobytes()
            pos += ln + int(rng.integers(*keep))
    return {n: b.decode() for n, b in bufs.items()}, planted


def _genomes(tmp):
    from sedef_tpu_torch.models.genome_sim import (simulate_genome,
                                                   write_fasta)
    out = {}
    for name, make in (("e2e-20M", lambda: simulate_genome(GENOME_BP,
                                                            **E2E_SPEC)),
                       ("mosaic-20M", mosaic_genome)):
        t0 = time.perf_counter()
        chroms, planted = make()
        fa = os.path.join(tmp, f"{name}.fa")
        write_fasta(fa, chroms)
        out[name] = (fa, planted)
        log(f"[main] {name}: {GENOME_BP} bp, {len(planted)} planted SDs, "
            f"made in {time.perf_counter() - t0:.1f}s")
    return out


# (run name, genome, bulk-batch floor in cells or None = the calibrated
# one, which ``run_pipeline`` installs); the card runs come first: the
# main path's launch counts are theirs
CARD_RUNS = (("e2e-20M card, calibrated floor", "e2e-20M", None),
             ("e2e-20M card, floor 2^18", "e2e-20M", LOW_FLOOR),
             ("mosaic-20M card, calibrated floor", "mosaic-20M", None))


def _aligner(route: str, floor):
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.ops import wavefront as wf
    al = wf.WavefrontAligner(DEFAULT, device="cuda" if route == "card"
                             else "cpu")
    if route == "host":
        # the reference package's CPU route: every gap DP on the native
        # scalar DP (a cpu aligner would send bulk batches to the plain
        # PyTorch versions)
        al.DEVICE_BATCH_MIN = sys.maxsize
    elif floor is not None:
        al.DEVICE_BATCH_MIN_CELLS = floor
    return al


def _run(fa, out_dir, al):
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.models.pipeline import run_pipeline
    t0 = time.perf_counter()
    paths = run_pipeline(fa, out_dir, DEFAULT, nbuckets=16, aligner=al,
                         jobs=JOBS, quiet=True, force=True)
    wall = time.perf_counter() - t0
    return wall, {s: open(paths[s], "rb").read() for s in ("aligned",
                                                          "final")}


def phase_main_path(genomes, tmp):
    from sedef_tpu_torch.models.genome_sim import recall_of
    from sedef_tpu_torch.ops import wavefront as wf
    _zero_counts()
    results = {}
    per_run = []
    for run, genome, floor in CARD_RUNS:
        al = _aligner("card", floor)
        before = [w.launches for w in wf.KERNEL_WRAPPERS]
        wall, out = _run(genomes[genome][0], os.path.join(tmp, "card"), al)
        results[run] = (wall, out, al)
        per_run.append((run, {w.__name__: w.launches - b for w, b in
                              zip(wf.KERNEL_WRAPPERS, before)
                              if w.launches > b}))
    launches = _read_counts()
    host = {}
    for genome, (fa, _) in genomes.items():
        host[genome] = _run(fa, os.path.join(tmp, "host"),
                            _aligner("host", None))
        log(f"[main] {genome} host route {host[genome][0]:.2f}s")
    for (run, genome, floor), (_, counts) in zip(CARD_RUNS, per_run):
        wall, out, al = results[run]
        for s in ("aligned", "final"):
            if out[s] != host[genome][1][s]:
                raise AssertionError(f"{run}: {s}.bed differs from the "
                                     f"host route")
        rows = out["final"].decode().splitlines()[1:]
        planted = genomes[genome][1]
        rec = recall_of(rows, planted)
        if not rows or rec <= 0:
            raise AssertionError(f"{run}: no planted SD recovered")
        log(f"[main] {run} ({al.DEVICE_BATCH_MIN} problems / "
            f"{al.DEVICE_BATCH_MIN_CELLS} cells): {wall:.2f}s vs host "
            f"{host[genome][0]:.2f}s; on the card {al.device_problems} "
            f"problems, {al.device_cells} cells, {al.device_batches} launch "
            f"groups, launches {counts}; aligned.bed "
            f"{len(out['aligned'].splitlines())} rows and final.bed = host "
            f"route's; {len(rows)} final SDs, recall {rec}/{len(planted)}")
        log(f"[main] {run} launch groups (route (S_q,S_t): groups, median "
            f"/ most problems a group): {_launch_groups(al)}")
    missing = [n for n in MAIN_PATH_KERNELS if launches[n] <= 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    return launches, host


# ---------------------------------------------------------------------------
# Phase 5b: the other entry points
# ---------------------------------------------------------------------------

# one process of the multi-process driver, started as the CLI's
# ``--coordinator/--num-processes/--process-id`` start it: a gloo group
# over localhost, the aligner on the card calibrated by devcal (the bulk
# floor fixed at the main path's LOW_FLOOR, so that the align stage reaches
# the card whatever two calibrations measure side by side; the launch
# counts start after the calibration's); the last stdout line is what it
# did on the card
DRIVER_WORKER = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
from sedef_tpu_torch import devcal
from sedef_tpu_torch.ops import wavefront as wf
from sedef_tpu_torch.parallel.distributed import (init_distributed,
                                                  run_pipeline_distributed)
fa, out, port, pid, n, nbuckets, jobs, floor = sys.argv[1:9]
init_distributed(f"localhost:{port}", int(n), int(pid), timeout_s=600)
al = wf.WavefrontAligner(device="cuda")
al.DEVICE_BATCH_MIN_CELLS = int(floor)
devcal.apply(al)
for w in wf.KERNEL_WRAPPERS:
    w.launches = 0
t0 = time.perf_counter()
run_pipeline_distributed(fa, out, nbuckets=int(nbuckets), jobs=int(jobs),
                         aligner=al, quiet=False, force=True)
wall = time.perf_counter() - t0
torch.distributed.destroy_process_group()
assert "jax" not in sys.modules and not any(
    m == "sedef_tpu" or m.startswith("sedef_tpu.") for m in sys.modules)
print(json.dumps({
    "pid": int(pid), "wall_s": wall, "problems": al.device_problems,
    "cells": al.device_cells, "launch_groups": al.device_batches,
    "floors": [al.DEVICE_BATCH_MIN, al.DEVICE_BATCH_MIN_CELLS],
    "groups": {f"{r} ({q},{t})": len(g)
               for (r, q, t), g in sorted(al.launch_groups.items())},
    "launches": {w.__name__: w.launches for w in wf.KERNEL_WRAPPERS}}))
"""
N_PROCESSES = 2


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _require_launched(what: str, counts: dict, names) -> None:
    missing = [n for n in names if counts.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"{what} launched no {missing}")


def _entry_driver(genomes, host, tmp):
    """(a) ``run_pipeline_distributed`` on e2e-20M in two processes on the
    one card: aligned.bed and final.bed equal to the host route's."""
    fa = genomes["e2e-20M"][0]
    out = os.path.join(tmp, "driver")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", DRIVER_WORKER, fa, out, str(port), str(pid),
         str(N_PROCESSES), "16", str(JOBS), str(LOW_FLOOR)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(N_PROCESSES)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for proc, (so, se) in zip(procs, outs):
        if proc.returncode:
            raise AssertionError(f"driver process failed ({proc.returncode})"
                                 f":\n{se[-3000:]}")
    for s in ("aligned", "final"):
        with open(os.path.join(out, f"{s}.bed"), "rb") as f:
            if f.read() != host["e2e-20M"][1][s]:
                raise AssertionError(f"driver: {s}.bed differs from the "
                                     f"host route")
    reports = [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]
    launches = {n: sum(r["launches"][n] for r in reports)
                for n in reports[0]["launches"]}
    for r, (_, se) in zip(reports, outs):
        floors = [ln for ln in se.splitlines() if ln.startswith("[devcal")]
        stages = [ln.strip() for ln in se.splitlines()
                  if ln.startswith(("[search:", "[bucket:", "[align:",
                                    "[stats:"))]
        log(f"[entry] driver process {r['pid']}: wall {r['wall_s']:.3f} s; "
            f"on the card {r['problems']} problems, {r['cells']} cells, "
            f"{r['launch_groups']} launch groups {r['groups']}; floors "
            f"{r['floors']}; {'; '.join(floors)}; {'; '.join(stages)}")
    log(f"[entry] driver e2e-20M, {N_PROCESSES} processes on one card "
        f"({smi('name,power.limit')}), floor {LOW_FLOOR} cells: wall "
        f"{wall:.3f} s with process start-up (the single-process card "
        f"route at that floor and the host route in the [main] lines, host "
        f"{host['e2e-20M'][0]:.3f} s); aligned.bed and final.bed = host "
        f"route's; launches {launches}")
    _require_launched("the driver", launches,
                      ("wavefront_fill", "backtrack_pack"))


def _mesh_mix(rng):
    """Problems of every class from 128 to 4,096 lanes, and two wider than
    GIANT_S_T."""
    import numpy as np
    pairs = []
    for lo, hi, cnt in [(60, 128, 12), (129, 256, 10), (257, 512, 8),
                        (513, 1024, 6), (1025, 2048, 4), (2049, 4096, 3),
                        (8400, 9800, 2)]:
        for _ in range(cnt):
            n = int(rng.integers(lo, hi + 1))
            q = rng.integers(0, 4, n).astype(np.int8)
            t = q.copy()
            mut = rng.random(n) < 0.08
            t[mut] = rng.integers(0, 4, int(mut.sum()))
            cut = int(rng.integers(0, max(1, n // 10)))
            pairs.append((q, t[:n - cut] if rng.random() < 0.5 else
                          np.concatenate([t, q[:cut]])))
    rng.shuffle(pairs)
    return pairs


def _entry_mesh_aligner():
    """(b) ``MeshAligner`` over the card listed twice: the single card
    aligner's CIGARs, kernels 1 and 2 launched."""
    import numpy as np
    import torch

    from sedef_tpu_torch import devcal
    from sedef_tpu_torch.ops import wavefront as wf
    from sedef_tpu_torch.parallel.mesh import MeshAligner
    pairs = _mesh_mix(np.random.default_rng(11))
    dev = torch.device("cuda", 0)
    mesh_al = MeshAligner([dev, dev])
    single = wf.WavefrontAligner(device="cuda")
    devcal.apply(mesh_al)
    devcal.apply(single)
    _zero_counts()
    t0 = time.perf_counter()
    got = mesh_al.align_batch(pairs) + mesh_al.align_batch(pairs[:3])
    t_mesh = time.perf_counter() - t0
    counts = _read_counts()
    t0 = time.perf_counter()
    want = single.align_batch(pairs) + single.align_batch(pairs[:3])
    t_single = time.perf_counter() - t0
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"MeshAligner: {bad} CIGARs differ from the "
                             f"single card aligner's")
    _require_launched("MeshAligner", counts,
                      ("wavefront_fill", "backtrack_pack"))
    widths = sorted({wf._pad_to_class(len(t)) for _, t in pairs})
    log(f"[entry] MeshAligner over cuda:0 twice: {len(pairs)} + 3 problems "
        f"(target classes {widths}), CIGARs = single aligner's; per entry "
        f"{[al.device_problems for al in mesh_al.aligners]} problems in "
        f"{[al.device_batches for al in mesh_al.aligners]} launch groups; "
        f"{t_mesh * 1e3:.3f} ms vs single {t_single * 1e3:.3f} ms (one "
        f"card either way); launches {counts}")


def _entry_multichip_step():
    """(c) ``multichip_step`` in a world of one on the card: the band
    bytes of the plain fill, total == B."""
    import torch
    import torch.distributed as dist

    from sedef_tpu_torch.ops import wavefront as wf
    from sedef_tpu_torch.parallel.mesh import (example_inputs, make_mesh,
                                               multichip_step)
    S_q, S_t, B = 1024, 1024, 16
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, "cuda")
        dev = torch.device("cuda", 0)
        args = example_inputs(1, 1, S_q, S_t, B)
        shard = [torch.from_numpy(a[0, 0]).to(dev) for a in args[:4]]
        _zero_counts()
        p, mcells, qg, total, total_passed, counts = multichip_step(
            mesh, S_q, S_t)(*shard, args[4])
        torch.cuda.synchronize()
        launches = _read_counts()
        plain = wf.wavefront_fill_torch(shard[0][:, :S_q].to(torch.int8),
                                        shard[1])
        bad, _ = _band_diff(p, plain, 0, S_q, S_t, 1)
        _require(bad, "multichip_step direction bytes")
        if int(total) != B or int(counts.sum()) != int(total_passed):
            raise AssertionError(f"multichip_step counters: total "
                                 f"{int(total)}, passed {int(total_passed)},"
                                 f" counts {counts.tolist()}")
        _require_launched("multichip_step", launches, ("wavefront_fill",))
        log(f"[entry] multichip_step, world of 1 ({dist.get_backend()}) on "
            f"the card, ({S_q},{S_t},{B}): band bytes = plain fill's, total "
            f"{int(total)}, passed {int(total_passed)}, mcells "
            f"{mcells.tolist()[:4]}..., qg {qg.tolist()[:4]}...; launches "
            f"{launches}")
    finally:
        dist.destroy_process_group()


def _entry_classify():
    """(d) ``classify_pair`` with a card aligner, every gap DP of the
    harness on the card (the native region core bypassed): the CPU's
    class for every pair, at least 4 hits of 5 at each error rate."""
    import random

    from sedef_tpu_torch.models import simulate as sim
    from sedef_tpu_torch.ops import wavefront as wf
    card = wf.WavefrontAligner(device="cuda")
    card.DEVICE_BATCH_MIN = 1
    card.DEVICE_BATCH_MIN_CELLS = 0
    cpu = wf.WavefrontAligner(device="cpu")
    old = os.environ.get("SEDEF_NATIVE_REGION")
    os.environ["SEDEF_NATIVE_REGION"] = "0"
    try:
        _zero_counts()
        classes = {}
        for error in (0, 10, 25):
            rng = random.Random(100 + error)
            got, want = [], []
            for _ in range(5):
                s1, s2, _ = sim.generate_random_sd(rng, error, min_len=1200,
                                                   max_len=6000)
                got.append(sim.classify_pair(s1, s2, error, aligner=card))
                want.append(sim.classify_pair(s1, s2, error, aligner=cpu))
            if got != want or got.count("hit") < 4:
                raise AssertionError(f"classify_pair at error {error}: card "
                                     f"{got}, cpu {want}")
            classes[error] = got
        counts = _read_counts()
    finally:
        if old is None:
            del os.environ["SEDEF_NATIVE_REGION"]
        else:
            os.environ["SEDEF_NATIVE_REGION"] = old
    _require_launched("classify_pair", counts,
                      ("wavefront_fill", "backtrack_pack"))
    log(f"[entry] classify_pair on the card = on the cpu: {classes}; "
        f"{card.device_problems} gap DPs on the card in "
        f"{card.device_batches} launch groups; launches {counts}")


def phase_entry_points(genomes, host, tmp):
    """The entry points beside ``run_pipeline``, each with the kernel
    counts set to 0 before it and read after it."""
    t0 = time.perf_counter()
    _entry_driver(genomes, host, tmp)
    _entry_mesh_aligner()
    _entry_multichip_step()
    _entry_classify()
    log(f"[entry] phase took {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Phase 5c: stage 1's device engines
# ---------------------------------------------------------------------------

# the roll engine's pair: the first ROLL_CUT_BP of one e2e-20M chromosome
# against itself and its reverse complement (a cut of scale, only to keep
# the phase inside the time limit: the engine launches ~60 tensor ops a
# roll step)
ROLL_CUT_BP = 2_000_000
SORT_OPS = 1.0  # operations a comparison of a sort (n log2 n of them)
SCAN_OPS = 8    # operations an element of the union-rank scan


def _sort_ops(rows: int, width: int) -> float:
    import math
    return SORT_OPS * rows * width * math.log2(max(width, 2))


def _op_costs():
    """(ops, bytes, rows shape) of one call of each stage-1 device op,
    from its arguments: every input read once and every output written
    once; the row sorts at n log2 n comparisons, the scans at a few
    operations an element (the work these inputs need)."""
    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def window_sketches(q_keys, qws, qwe, lut, SQ):
        B = qws.shape[0]
        return (2 * _sort_ops(B, SQ) + 4 * B * SQ,
                nb(q_keys, qws, qwe, lut) + B * SQ * 4 + B * 9, (B, SQ))

    def span_intersections(r_keys, qk_all, sa, sb, SA, n_shift):
        B, SQ = qk_all.shape
        return (_sort_ops(B, SA) + _sort_ops(B, SQ + SA)
                + SCAN_OPS * B * (SQ + SA),
                nb(r_keys, qk_all, sa, sb) + B * 4, (B, SQ + SA))

    def composition_ideals(r_keys, qk_all, s_all, a, b, iv_id, RW,
                           n_shift):
        N, SQ = a.shape[0], qk_all.shape[1]
        return (_sort_ops(N, RW) + _sort_ops(N, SQ + RW)
                + SCAN_OPS * N * (SQ + RW),
                nb(r_keys, qk_all, s_all, a, b, iv_id) + N * 4,
                (N, SQ + RW))

    def device_index(code, cls, nk_valid, k, w, cap, drop=0):
        import math
        n = code.shape[0]
        return (n * (3 * k + 2 * math.log2(k) + 2 * math.log2(w) + 12),
                2 * n + 2 * cap * 4 + 4, (n,))

    def roll_batch(r_keys, r_locs, nr, lut, q_keys, qws, qwe, t0, rws0,
                   init_cnt, n_steps, re0, W, SQ, INIT_PAD, T_PAD,
                   n_shift, init_max=None, steps_max=None):
        # the steps the batch's rows need, a W-wide row pass of ~13
        # element operations for each of the add and the remove a step
        B = qws.shape[0]
        steps = int(init_cnt.clamp(max=INIT_PAD).sum()) \
            + 2 * int(n_steps.clamp(max=T_PAD).sum())
        return (13 * W * steps,
                nb(r_keys, r_locs, q_keys, qws, qwe, t0, rws0, init_cnt,
                   n_steps, re0) + B * 9, (B, W, T_PAD))

    return {"_window_sketches": window_sketches,
            "_span_intersections": span_intersections,
            "_composition_ideals": composition_ideals,
            "_device_index": device_index, "_roll_batch": roll_batch}


class OpTimer:
    """Wraps the stage-1 device ops in their modules: per op, calls,
    CUDA-event time around each call (its kernels as the host launched
    them), the summed bound of the calls' work, and the largest rows
    shape of a call."""

    def __init__(self):
        from sedef_tpu_torch.ops import prefilter, roll_engine, winnow_device
        self.mods = {"_window_sketches": prefilter,
                     "_span_intersections": prefilter,
                     "_composition_ideals": prefilter,
                     "_device_index": winnow_device,
                     "_roll_batch": roll_engine}
        self.costs = _op_costs()
        self.real = {}
        self.reset()

    def reset(self):
        self.events = {n: [] for n in self.mods}
        self.work = {n: [0.0, 0.0] for n in self.mods}
        self.shape = {}

    def __enter__(self):
        import torch
        for name, mod in self.mods.items():
            real = self.real[name] = getattr(mod, name)

            def wrapped(*a, _n=name, _f=real, **kw):
                ops, nbytes, shape = self.costs[_n](*a, **kw)
                self.work[_n][0] += ops
                self.work[_n][1] += nbytes
                self.shape[_n] = max(self.shape.get(_n, shape), shape)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = _f(*a, **kw)
                e1.record()
                self.events[_n].append((e0, e1))
                return out

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, self.real[name])

    def read(self) -> dict:
        import torch
        torch.cuda.synchronize()
        out = {}
        for name, evs in self.events.items():
            if evs:
                ops, nbytes = self.work[name]
                out[name] = {"launches": len(evs),
                             "ms": sum(a.elapsed_time(b) for a, b in evs),
                             "shape": self.shape.get(name),
                             **bound(ops, nbytes)}
        return out


def _stage1_index(fr, names, k, w, timer):
    """The device index build on both strands of every chromosome against
    the host scan and the stable sort."""
    import numpy as np
    import torch

    from sedef_tpu_torch.ops.dna import PackedSeq
    from sedef_tpu_torch.ops.winnow import minimizers
    from sedef_tpu_torch.ops.winnow_device import device_index_arrays
    seqs = [PackedSeq(n, fr.get_sequence(n), is_rc=rc)
            for n in names for rc in (False, True)]
    device_index_arrays(seqs[0].code[:100_000], seqs[0].cls[:100_000], k,
                        w, device="cuda")  # first-call set-up, untimed
    ms, host_ms = [], []
    with timer:
        for s in seqs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = device_index_arrays(s.code, s.cls, k, w, device="cuda")
            ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            keys, locs = minimizers(s.code, s.cls, k, w)
            order = np.argsort(keys, kind="stable")
            host_ms.append((time.perf_counter() - t0) * 1e3)
            want = (keys, locs, keys[order], locs[order])
            if got is None or any(g.dtype != x.dtype or
                                  not np.array_equal(g, x)
                                  for g, x in zip(got, want)):
                raise AssertionError(f"device index of {s.name} "
                                     f"(rc={s.is_rc}) != host")
    log(f"[stage1] device index: {len(seqs)} strands of "
        f"{len(seqs[0].code)} bp = host minimizers + stable sort; ms per "
        f"strand (host clock, with the copies): "
        + ", ".join(f"{m:.3f}" for m in ms) + "; the host's (native scan "
        "and numpy's stable sort): " + ", ".join(f"{m:.3f}" for m in host_ms))
    return {"card_ms": ms, "host_ms": host_ms}


def _stage1_prefilter(fr, bins, name, timer):
    """search_stage(jobs=1) with the prefilter forced on against the host
    route: seeds.bed byte-identical."""
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.models import pipeline as pl
    from sedef_tpu_torch.models import seeder
    from sedef_tpu_torch.ops import prefilter
    cache = pl.IndexCache(fr, DEFAULT, use_device="cuda")
    for b in bins:
        for c in b:
            cache.get(c, False)
            cache.get(c, True)
    old = seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS
    seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS = True, 0
    prefilter.reset_stats()
    try:
        with timer:
            t0 = time.perf_counter()
            dev = pl.search_stage(fr, bins, DEFAULT, use_device="cuda",
                                  jobs=1, cache=cache)
            wall_dev = time.perf_counter() - t0
    finally:
        seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS = old
    stats = dict(prefilter.STATS)
    t0 = time.perf_counter()
    host = pl.search_stage(fr, bins, DEFAULT, use_device=False, jobs=1,
                           cache=cache)
    wall_host = time.perf_counter() - t0
    if "\n".join(dev) != "\n".join(host) or not host:
        raise AssertionError(f"{name}: prefiltered seeds.bed != host")
    if not stats["intervals"]:
        raise AssertionError(f"{name}: the prefilter ran on no interval")
    log(f"[stage1] prefilter {name} (search_stage jobs=1, forced on): "
        f"{stats['intervals']} intervals planned, {stats['pruned_a']} "
        f"pruned in phase A, {stats['pruned_b']} in phase B, "
        f"{stats['rows']} composition rows, device {stats['device_ms']:.3f}"
        f" ms from dispatch to collect (CUDA events, summed over the pairs: "
        f"their windows overlap in the two-phase loop); stage-1 wall "
        f"{wall_dev:.3f} s on the card against {wall_host:.3f} s on the "
        f"host; {len(host)} seeds, seeds.bed = host route's")
    return dict(stats, wall_card_s=wall_dev, wall_host_s=wall_host)


def _stage1_gates(genomes, host, tmp):
    """One run_pipeline(jobs=1) of e2e-20M on the card under the gates
    devcal.apply installs: aligned.bed and final.bed = the host route's."""
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.models import seeder
    from sedef_tpu_torch.models.pipeline import run_pipeline
    from sedef_tpu_torch.ops import prefilter
    al = _aligner("card", None)
    prefilter.reset_stats()
    t0 = time.perf_counter()
    paths = run_pipeline(genomes["e2e-20M"][0], os.path.join(tmp, "gates"),
                         DEFAULT, nbuckets=16, aligner=al, jobs=1,
                         quiet=True, force=True)
    wall = time.perf_counter() - t0
    for s in ("aligned", "final"):
        if open(paths[s], "rb").read() != host["e2e-20M"][1][s]:
            raise AssertionError(f"gates run: {s}.bed != host route's")
    stats = dict(prefilter.STATS)
    log(f"[stage1] calibrated gates (devcal.apply): PREFILTER_ON="
        f"{seeder.PREFILTER_ON} PREFILTER_MIN_STEPS="
        f"{seeder.PREFILTER_MIN_STEPS}; run_pipeline(jobs=1) e2e-20M on the "
        f"card {wall:.3f} s, prefilter on {stats['intervals']} intervals "
        f"({stats['pruned_a'] + stats['pruned_b']} pruned); aligned.bed and "
        f"final.bed = host route's")
    return {"prefilter_on": seeder.PREFILTER_ON,
            "prefilter_min_steps": seeder.PREFILTER_MIN_STEPS,
            "wall_s": wall, "intervals": stats["intervals"]}


def _stage1_roll(fr, name, k, w, timer):
    """The roll engine forced on for the first ROLL_CUT_BP of ``name``
    against itself, forward and reverse complement: seeds = the host
    route's; RollEngine.run on the card = on the CPU for one full batch;
    a full batch of the 4,096 class besides."""
    import numpy as np
    import torch

    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.models import seeder
    from sedef_tpu_torch.native import lib as native
    from sedef_tpu_torch.ops import roll_engine as re_
    from sedef_tpu_torch.ops.dna import PackedSeq
    from sedef_tpu_torch.ops.index import MinimizerIndex
    from sedef_tpu_torch.ops.stat_model import relaxed_jaccard_estimate
    seq = fr.get_sequence(name)[:ROLL_CUT_BP]
    qh = MinimizerIndex(PackedSeq(name, seq), k, w)
    rc = MinimizerIndex(PackedSeq(name, seq, is_rc=True), k, w)
    out = {"cut_bp": ROLL_CUT_BP, "pairs": []}
    old = seeder.ROLL_DEVICE_MIN
    for rh, same in ((qh, True), (rc, False)):
        plan = native.search_plan(qh, rh, same, DEFAULT)
        steps = plan[1][:, 4]
        classes = {T: int(sum(re_._t_class(int(s)) == T for s in steps))
                   for T in (*re_.T_PAD_LADDER, 0)}
        t0 = time.perf_counter()
        host = seeder.initial_search(qh, rh, same, DEFAULT,
                                     use_device=False)
        wall_host = time.perf_counter() - t0
        seeder.ROLL_DEVICE_MIN = 0
        try:
            with timer:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = seeder._device_roll_results(qh, rh, plan, DEFAULT,
                                                  "cuda")
                wall_roll = time.perf_counter() - t0
                dev = seeder.initial_search(qh, rh, same, DEFAULT,
                                            use_device="cuda")
        finally:
            seeder.ROLL_DEVICE_MIN = old
        if [h.to_bed() for h in dev] != [h.to_bed() for h in host]:
            raise AssertionError(f"roll engine {name} rc={rh.seq.is_rc}: "
                                 f"seeds != host route's")
        rolled = int(steps[res[2]].sum())
        pair = {"rc": rh.seq.is_rc, "intervals": len(steps),
                "classes": classes, "ok": int(res[2].sum()),
                "steps_rolled": rolled, "roll_wall_s": wall_roll,
                "steps_per_s": rolled / wall_roll,
                "host_search_wall_s": wall_host,
                "host_planned_steps_per_s": int(steps.sum()) / wall_host}
        out["pairs"].append(pair)
        log(f"[stage1] roll engine {name}[:{ROLL_CUT_BP}] (cut to keep "
            f"the phase inside the time limit) vs "
            f"{'its reverse complement' if rh.seq.is_rc else 'itself'}: "
            f"{len(steps)} intervals (T classes {classes}), {pair['ok']} "
            f"rolled on the card ({rolled} steps in {wall_roll:.3f} s = "
            f"{pair['steps_per_s']:.0f} steps/s); the host's whole native "
            f"search {wall_host:.3f} s ({pair['host_planned_steps_per_s']:.0f}"
            f" planned steps/s); seeds = host route's")

    # one full batch of each T class, on the card against the CPU
    win, iv = native.search_plan(qh, qh, True, DEFAULT)
    woff = np.repeat(np.arange(len(win)), win[:, 3])
    cols = [win[woff, 1], win[woff, 2], iv[:, 0], iv[:, 2], iv[:, 3],
            iv[:, 4], iv[:, 5]]
    cols = [np.asarray(c, np.int32) for c in cols]
    # the plan's intervals repeated to fill a batch, and the 4,096 class:
    # the same windows rolled over 4,000 steps
    small = np.resize(np.nonzero(cols[5] <= re_.T_PAD_LADDER[0])[0],
                      re_.DEFAULT_BATCH)
    long_ = np.resize(np.nonzero(cols[6] + 4000 < len(seq))[0],
                      re_.DEFAULT_BATCH)
    cols_long = [c[long_].copy() for c in cols]
    cols_long[5][:] = 4000
    lut = np.array([relaxed_jaccard_estimate(s, k, DEFAULT)
                    for s in range(161)], np.int32)
    eng = re_.RollEngine(k, lut)
    for label, cc, check_cpu in (("512", [c[small] for c in cols], True),
                                 ("4096", cols_long, False)):
        args = (len(qh.keys), len(qh.seq), *cc)
        dk, dl = qh.device_arrays("cuda")
        with timer:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = eng.run(dk, dk, dl, *args)
            wall = time.perf_counter() - t0
        msg = ""
        if check_cpu:
            ck, cl = qh.device_arrays("cpu")
            cpu = eng.run(ck, ck, cl, *args)
            if any(not np.array_equal(a, b) for a, b in zip(got, cpu)):
                raise AssertionError("RollEngine.run on the card != CPU")
            msg = "; (best_j, best_steps, ok) = the CPU run's"
        rolled = int(cc[5][got[2]].sum())
        out[f"batch_{label}"] = {"ms": wall * 1e3, "ok": int(got[2].sum()),
                                 "steps_per_s": rolled / wall}
        log(f"[stage1] roll engine, one batch of {len(cc[0])} x W "
            f"{re_.DEFAULT_W} in the {label} class (the self plan's "
            f"intervals, repeated): {wall * 1e3:.3f} ms, "
            f"{int(got[2].sum())} ok, {rolled / wall:.0f} steps/s{msg}")
    return out


def phase_stage1(genomes, host, tmp):
    """Stage 1's device engines on the main path's genomes, each held
    against the host route (``[stage1]`` lines and one JSON line)."""
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.io.fasta import FastaReference, generate_translation
    t_phase = time.perf_counter()
    k, w = DEFAULT.search.kmer_size, DEFAULT.search.window_size
    timer = OpTimer()
    summary = {}
    fr = FastaReference(genomes["e2e-20M"][0])
    bins = generate_translation(fr)
    names = [c for b in bins for c in b]
    summary["index"] = _stage1_index(fr, names, k, w, timer)
    summary["prefilter"] = {"e2e-20M": _stage1_prefilter(fr, bins, "e2e-20M",
                                                         timer)}
    ops = timer.read()  # the e2e-20M whole-job run's ops
    frm = FastaReference(genomes["mosaic-20M"][0])
    summary["prefilter"]["mosaic-20M"] = _stage1_prefilter(
        frm, generate_translation(frm), "mosaic-20M", OpTimer())
    summary["gates"] = _stage1_gates(genomes, host, tmp)
    roll_timer = OpTimer()
    summary["roll"] = _stage1_roll(fr, names[0], k, w, roll_timer)
    ops.update(roll_timer.read())
    summary["ops"] = ops
    for name, o in ops.items():
        log(f"[stage1] op {name}: {o['launches']} calls, {o['ms']:.3f} ms "
            f"(CUDA events), bound {o['bound_ms']:.4f} ms by "
            f"{o['bound_by']}, largest rows shape {o['shape']}")
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[stage1] phase took {summary['phase_s']:.1f}s")
    log("[stage1] " + json.dumps(summary, default=str))
    return summary


# ---------------------------------------------------------------------------
# Phase 5d: the main path at hg19 seed density
# ---------------------------------------------------------------------------

# the dense rehearsal recipe (sedef_tpu_torch.tools.rehearsal) on 2
# chromosomes, seed 1905, nbuckets and jobs as tools/dense_parity.py ran
# it; by default at 50 Mbp (cut from that tool's 100 Mbp for the time
# limit; 0.64 seeds/Kbp there against 0.70 at 100 Mbp), --dense-mbp 100
# for its genome
DENSE_MBP = 50
DENSE_CHROMS = 2
DENSE_NBUCKETS = 64
# the reference package's rows on the 100 Mbp genome
# (docs/HG19_DENSE_PARITY.json, an older tree: reported beside the port's,
# not asserted)
DENSE_RECORDED = {"seeds": 69_674, "aligned": 16_923, "final": 16_922}


class _LaunchEvents:
    """CUDA events on the launching stream around every kernel launch of
    the wrappers (``wf._launch`` wrapped while the block runs, no
    profiler): ``ms()`` gives {wrapper: (summed event-bracketed ms,
    launches)}."""

    what = ("kernel time (CUDA events around each of the wrappers' "
            "launches, summed, not a profiler's busy share: an upper bound, "
            "as the other job thread's work on the stream can fall between "
            "a pair; copies and torch's own kernels outside one are not in "
            "it)")

    def __enter__(self):
        import threading

        import torch

        from sedef_tpu_torch.ops import wavefront as wf
        self.wf, self.launch = wf, wf._launch
        self.lock, self.events = threading.Lock(), []

        def timed(wrapper, dev, fn, *args):
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            self.launch(wrapper, dev, fn, *args)
            end.record(stream)
            with self.lock:
                self.events.append((wrapper.__name__, start, end))
        wf._launch = timed
        return self

    def __exit__(self, *exc):
        self.wf._launch = self.launch

    def ms(self) -> dict:
        import torch
        torch.cuda.synchronize()
        per = {}
        for name, start, end in self.events:
            ms, n = per.get(name, (0.0, 0))
            per[name] = (ms + start.elapsed_time(end), n + 1)
        return per


class _CudaTrace:
    """torch.profiler's CUDA activity alone over the block (the card's
    kernels and copies, no host-op tracing): ``ms()`` gives {kernel or
    copy: (device ms, calls)}."""

    what = "device busy (torch.profiler, CUDA activity: kernels and copies)"

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def ms(self) -> dict:
        per = {}
        for ev in self.prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us > 0:
                per[ev.key] = (us / 1e3, ev.count)
        return per


def _launch_groups(al) -> str:
    import statistics
    return "; ".join(
        f"{route} ({S_q},{S_t}): {len(g)}, {statistics.median(g):g} / "
        f"{max(g)}" for (route, S_q, S_t), g in sorted(
            getattr(al, "launch_groups", {}).items()))


def phase_dense(tmp, mbp, profile=False):
    """The dense recipe at ``mbp`` Mbp through ``run_pipeline`` on the card
    route at the calibrated floor, each kernel launch timed by CUDA events
    (with ``profile``: traced by torch.profiler's CUDA activity instead),
    then on the host route: the three beds byte-equal.  Returns the card
    run's launches, per wrapper."""
    import torch

    from sedef_tpu_torch.tools import rehearsal
    t_phase = time.perf_counter()
    work = os.path.join(tmp, "dense")
    t0 = time.perf_counter()
    fa, planted = rehearsal.generate("dense", mbp, work, DENSE_CHROMS)
    spec = rehearsal.spec_of("dense", mbp, DENSE_CHROMS)
    log(f"[dense] {spec}: {planted} planted SDs, made in "
        f"{time.perf_counter() - t0:.1f}s")
    al = _aligner("card", None)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with (_CudaTrace() if profile else _LaunchEvents()) as events:
        card, card_paths = rehearsal.run(fa, os.path.join(work, "card"), al,
                                         JOBS, DENSE_NBUCKETS, echo=False)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    kernel_ms = events.ms()
    busy = sum(ms for ms, _ in kernel_ms.values())
    host, host_paths = rehearsal.run(fa, os.path.join(work, "host"),
                                     _aligner("host", None), JOBS,
                                     DENSE_NBUCKETS, echo=False)
    for s in ("seeds", "aligned", "final"):
        if (open(card_paths[s], "rb").read()
                != open(host_paths[s], "rb").read()):
            raise AssertionError(f"[dense] {s}.bed differs between the card "
                                 f"and the host route")
    _require_launched("the dense card run", counts,
                      ("wavefront_fill", "backtrack_pack"))
    if busy <= 0:
        raise AssertionError(f"[dense] no device time: {events.what}")
    widest = max(((S_t, S_q, route) for (route, S_q, S_t)
                  in al.launch_groups), default=None)
    log(f"[dense] card route (calibrated floor: {al.DEVICE_BATCH_MIN} "
        f"problems / {al.DEVICE_BATCH_MIN_CELLS} cells) {card['wall_s']:.3f}"
        f" s, stages {card['stage_s']}; host route {host['wall_s']:.3f} s, "
        f"stages {host['stage_s']}; seeds.bed, aligned.bed and final.bed "
        f"byte-equal")
    log(f"[dense] rows {card['rows']}, {card['seeds_per_kbp']:.4f} "
        f"seeds/Kbp (the reference package's record at 100 Mbp: "
        f"{DENSE_RECORDED}, {DENSE_RECORDED['seeds'] / 1e5:.4f} seeds/Kbp)")
    log(f"[dense] on the card {card['device_problems']} problems, "
        f"{card['device_cells']} cells, {card['device_batches']} launch "
        f"groups; widest class (S_t, S_q, route) {widest}; peak device "
        f"memory {peak / 2**20:.1f} MiB; launches {counts}")
    log(f"[dense] launch groups (route (S_q,S_t): groups, median / most "
        f"problems a group): {_launch_groups(al)}")
    log(f"[dense] {events.what} {busy:.3f} ms, "
        f"{100 * busy / 1e3 / card['wall_s']:.3f}% of the card run's wall; "
        + "; ".join(f"{k[:48]} {ms:.3f} ms x{n}" for k, (ms, n) in sorted(
            kernel_ms.items(), key=lambda kv: -kv[1][0])[:6]))
    log(f"[dense] phase took {time.perf_counter() - t_phase:.1f}s")
    return counts


# ---------------------------------------------------------------------------
# Phase 5e: the accuracy table's classification on the card and the CPU
# ---------------------------------------------------------------------------

ACCURACY_RATES = (0, 5, 10, 15, 20, 25, 30)
ACCURACY_RUNS = 10
ACCURACY_MAX_LEN = 20_000


def phase_accuracy():
    """``accuracy_table``'s per-rate classification (ACCURACY_RUNS pairs a
    rate, 1,000-ACCURACY_MAX_LEN bp, one process) with a card aligner at
    its calibrated floors and with a cpu one (whose stage 1 runs on the
    host: the seeder's stage-1 gates, which ``devcal.apply`` set for this
    process, are never read for it): the same class for every pair."""
    from sedef_tpu_torch.tools import accuracy_table as acc
    from sedef_tpu_torch.tools.rehearsal import make_aligner
    t_phase = t0 = time.perf_counter()
    _zero_counts()
    al = make_aligner("cuda")
    card = {e: acc.classify_rate(e, ACCURACY_RUNS, ACCURACY_MAX_LEN,
                                 aligner=al) for e in ACCURACY_RATES}
    counts = _read_counts()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = {e: acc.classify_rate(e, ACCURACY_RUNS, ACCURACY_MAX_LEN,
                                device="cpu") for e in ACCURACY_RATES}
    cpu_s = time.perf_counter() - t0
    for e in ACCURACY_RATES:
        if card[e] != cpu[e]:
            raise AssertionError(f"[accuracy] error {e}: card {card[e]}, "
                                 f"cpu {cpu[e]}")
    log("[accuracy] error;hits;misses;partials (card = cpu, pair by pair): "
        + " ".join(acc.row(e, {c: card[e].count(c) for c in acc.CLASSES})
                   for e in ACCURACY_RATES))
    log(f"[accuracy] {ACCURACY_RUNS} pairs a rate, 1000-{ACCURACY_MAX_LEN} "
        f"bp: card {card_s:.3f} s ({al.device_problems} gap DPs on the card "
        f"in {al.device_batches} launch groups; launches {counts}), cpu "
        f"{cpu_s:.3f} s")
    log(f"[accuracy] phase took {time.perf_counter() - t_phase:.1f}s")


def phase_spread(genomes, tmp, n):
    """``n`` timed runs per route and genome, routes alternated (one
    untimed warm run first)."""
    import statistics
    routes = [("host", None), ("card", None), ("card", LOW_FLOOR)]
    for genome, (fa, _) in genomes.items():
        walls = {r: [] for r in routes}
        finals = set()
        for rep in range(n + 1):
            for route, floor in routes:
                wall, out = _run(fa, os.path.join(tmp, "spread"),
                                 _aligner(route, floor))
                finals.add(out["final"])
                if rep:
                    walls[(route, floor)].append(wall)
        if len(finals) != 1:
            raise AssertionError(f"{genome}: final.bed differs between "
                                 f"spread runs")
        for (route, floor), ws in walls.items():
            log(f"[spread] {genome} {route} floor "
                f"{floor or 'calibrated'}: runs "
                f"{', '.join(f'{w:.4f}' for w in ws)} s, median "
                f"{statistics.median(ws):.4f} s")


def phase_profile(genomes, tmp):
    """Device busy time of each card run under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    for run, genome, floor in CARD_RUNS:
        al = _aligner("card", floor)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = _run(genomes[genome][0], os.path.join(tmp, "prof"), al)
        rows = []
        busy = 0.0
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            if dev_us > 0:
                busy += dev_us
                rows.append((dev_us, ev.key, ev.count))
        rows.sort(reverse=True)
        top = "; ".join(f"{k[:64]} {us / 1e3:.3f} ms x{c}"
                        for us, k, c in rows[:8])
        log(f"[profile] {run}: wall {wall:.3f} s, device busy "
            f"{busy / 1e3:.3f} ms ({100 * busy / 1e6 / wall:.2f}%); {top}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spread", type=int, default=0,
                    help="timed runs per route and genome (default 0)")
    ap.add_argument("--profile", action="store_true",
                    help="trace each card run with torch.profiler (the "
                         "[dense] card run's CUDA activity in place of its "
                         "CUDA events)")
    ap.add_argument("--dense-mbp", type=float, default=DENSE_MBP,
                    help=f"size of the [dense] genome in Mbp (default "
                         f"{DENSE_MBP}; 100: the genome whose rows the "
                         f"reference package recorded)")
    ap.add_argument("--main-only", action="store_true",
                    help="build and the main path alone: no kernel phase, "
                         "no calibration phase, no result line")
    args = ap.parse_args()
    t_start = time.perf_counter()
    phase_device()
    import torch
    phase_build()
    if not args.main_only:
        summary = KernelPhase().run()
        t0 = time.perf_counter()
        calibration = phase_calibration()
        log(f"[calibration] phase took {time.perf_counter() - t0:.1f}s")
    with tempfile.TemporaryDirectory() as tmp:
        genomes = _genomes(tmp)
        t0 = time.perf_counter()
        launches, host = phase_main_path(genomes, tmp)
        log(f"[main] phase took {time.perf_counter() - t0:.1f}s")
        if not args.main_only:
            phase_entry_points(genomes, host, tmp)
            phase_stage1(genomes, host, tmp)
            dense_launches = phase_dense(tmp, args.dense_mbp, args.profile)
            phase_accuracy()
        if args.spread:
            phase_spread(genomes, tmp, args.spread)
        if args.profile:
            phase_profile(genomes, tmp)
    if args.main_only:
        return 0
    # launches: the main path's for kernels 1-9, the calibration path's
    # for the variant kernel (the path that runs it)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": ref,
                "launches": (launches if name in MAIN_PATH_KERNELS
                             else calibration)[name],
                "calibration_launches": calibration[name],
                "dense_launches": dense_launches[name],
                **summary[name]} for name, (src, ref) in KERNELS.items()]
    log(f"[smoke] took {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
