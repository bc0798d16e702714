#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``sedef_tpu_torch``) on one card.

    python3 chip_smoke.py [--spread N] [--profile] [--main-only]
                          [--dense-mbp N] [--prefilter-split]

Phases, one line each or more (any failure exits non-zero, with no result
line):

1. the card: ``nvidia-smi`` name and power limit, torch / CUDA versions;
2. build: the native host runtime and the CUDA kernels, from this
   checkout's sources; the roll kernel's registers and spill bytes as
   ptxas reports them for each row width (a spill fails);
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
   plain fill's, its q-gram gate (kernel ``csrc/qgram.cu``) equal to the
   plain version's, total == B, then the q-gram kernel against its plain
   version on 16,384 pairs at W 128, timed; (d) ``classify_pair`` with
   every gap DP on the card, the CPU's class for each of 15 seeded pairs;
5c. stage 1's device engines (``[stage1]`` lines, one JSON line of them):
   the device index build (kernel ``csrc/device_index.cu``) on both
   strands of every e2e-20M chromosome against the host scan and the
   stable sort, and the kernel against its plain version on a first
   segment (timed), a continuation segment and a segment past its
   capacity; ``search_stage(jobs=1)``
   (the whole-job path) on both genomes with the roll prefilter forced on
   and then with the roll engine forced on (``ROLL_DEVICE_MIN = 0``),
   seeds.bed byte-identical to the host route's, with the intervals
   planned and pruned in each phase, the composition rows, the device ms
   of the dispatches and the stage-1 walls, and the prefilter's host time
   a dispatch split into plan, upload, launch, pull and verdicts with its
   launches, uploads, pulls and bytes (``PrefilterSplit``); every launch
   of the per-interval kernel (``csrc/prefilter_intervals.cu``) in the
   prefilter runs against its plain version on the same tensors, the
   largest timed; compute-sanitizer's memcheck and racecheck of the
   per-interval kernel on a small plan, where the tool runs on the card;
   one ``run_pipeline(jobs=1)`` of e2e-20M under the prefilter gates
   ``devcal.apply`` installs, beds equal to the host route's, its
   launches the stage-1 kernels' main-path launches, its prefilter calls
   checked and split as above; the roll engine (kernel
   ``csrc/roll_engine.cu``), then the prefilter,
   forced on for the dense genome's first chromosome (25 Mbp at the
   default 50) against itself and its reverse complement, seeds equal to
   the host route's; every roll-forced run's calls split
   (``RollSplit``: one upload, one launch and one pull a pair, or it
   fails; host ms a call by part; the kernel's summed ms, CUDA events
   around its launch call); one full batch (1,024 intervals, W 512) of
   each roll-length class (ns a counted and ns a performed update on the
   longest chain), edge rows (empty query windows,
   HAS_N keys, a window past SQ, rows past each class, stores of 64
   entries) and one merged ``RollEngine.run`` over n_steps 1-4,097 (one
   launch, against the plain version by class) on the card, the 512
   class also against ``RollEngine.run`` on the CPU; each device op's
   calls, CUDA-event ms and bound, and each stage-1 kernel's launches on
   these paths (each path's count from 0), its ms against the plain
   version's and its bound;
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
   the same card and host; no kernel summary and no result line); with
   ``--prefilter-split``: phases 1 and 2 and 5c's whole-job runs and
   calibrated-gates run alone, their walls and prefilter host split, no
   check beyond seeds equal (copied into another checkout whose package
   binds its kernels through ``native/kernels.py``, it times that
   checkout's prefilter).

Each kernel's bound in the summary is the larger of its integer operations
over the card's int32 peak (SMs x 64 lanes x the SM clock ``nvidia-smi``
reports as its maximum) and the bytes it must move over the HBM rate, for
the work this run's inputs need: 29 operations per band cell of a fill (23
for the checkpoint pass, which keeps no direction flags), 43 per consumed
row of a traceback; the variant kernel is held to half its fill's
operations (the 16x2 cell of ``csrc/dp_cell2.cuh`` does two lanes an
instruction), and its line also carries the one-lane and the byte bound.
No single PyTorch call computes an affine-gap
direction matrix or its traceback, an interval's roll, a window's ideal, a
window's distinct sorted keys, a winnowed minimizer index or a q-gram
histogram intersection, or an interval's prefilter verdict, so
``library_ms`` is null throughout.  A stage-1
kernel's bound counts the work its inputs need (``_least_work``): for a
roll its query sketch and 16 operations for each sketch update that its
inputs force (``_roll_updates``: the init adds and each cursor's fires,
not two a step); for a window-ideal row of n keys n
log2 n comparisons, a search of the query row and a scan element a key;
for a query sketch of n keys n log2 n comparisons and a compaction step;
for an interval's verdict its sketch, its span's keys searched in it,
and for phase B's pruned intervals every window ranked (one window for
an interval left alive);
16 a k-mer position of the index build; 12 a q-gram;
``bound_formula_ms`` beside it holds the call to ``_op_costs``' formulas,
the plain versions' W- or width-wide row passes, by which the stage-1 op
lines are held.

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
    from sedef_tpu_torch.native import kernels
    from sedef_tpu_torch.native.build import build_cuda, build_native
    # g++ and the nvcc compiles (one per source) run side by side
    from concurrent.futures import ThreadPoolExecutor
    took, compiler = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        took[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(timed, "native",
                            lambda: build_native(force=True)),
                pool.submit(timed, "cuda",
                            lambda: build_cuda(verbose=True, force=True,
                                               log=compiler))]
        for job in jobs:
            job.result()
    kernels.library()
    log(f"[build] native {took['native']:.2f}s cuda {took['cuda']:.2f}s, "
        f"together {time.perf_counter() - t0:.2f}s")
    _roll_ptxas(compiler.get("roll_engine", ""))


def _ptxas_usage(text: str, kernel: str) -> dict:
    """Per instantiation of the template ``kernel`` (its int argument, from
    the mangled name) in ``-Xptxas -v`` output: registers, stack frame and
    spill bytes."""
    import re
    out, cur = {}, None
    for line in text.splitlines():
        if "entry function" in line or "Function properties for" in line:
            m = re.search(rf"{kernel}ILi(\d+)E", line)
            cur = out.setdefault(int(m.group(1)), {}) if m else None
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(zip(("stack", "spill_stores", "spill_loads"),
                               map(int, m.groups())))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def _roll_ptxas(text: str):
    """The roll kernel's instantiations as ptxas built them (``text``: the
    compiler's ``-Xptxas -v`` output for its source): registers and spills
    of each (its register row must not spill: 0 bytes)."""
    from sedef_tpu_torch.ops.roll_engine import KERNEL_W
    use = _ptxas_usage(text, "roll_batch_kernel")
    want = sorted(W // 32 for W in KERNEL_W)
    if sorted(use) != want or any(len(u) != 4 for u in use.values()):
        raise AssertionError(f"ptxas reported {use} for the roll kernel, "
                             f"not E in {want}")
    ROLL_PTXAS.update({f"W{32 * E}": u for E, u in use.items()})
    log("[build] csrc/roll_engine.cu, ptxas -v: " + "; ".join(
        f"W {32 * E} (E {E}): {u['registers']} registers, "
        f"{u['stack']} bytes stack frame, {u['spill_stores']} / "
        f"{u['spill_loads']} bytes spill stores / loads"
        for E, u in sorted(use.items())))
    spills = {E: u for E, u in use.items()
              if u["spill_stores"] or u["spill_loads"]}
    if spills:
        raise AssertionError(f"the roll kernel's register row spills: "
                             f"{spills}")


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
    from sedef_tpu_torch.ops import wavefront as wf
    rng = np.random.default_rng(5)
    rows = []
    for n in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
        pairs = [(rng.integers(0, 4, int(a)).astype(np.int8),
                  rng.integers(0, 4, int(b)).astype(np.int8))
                 for a, b in rng.integers(96, 129, (n, 2))]
        host_pairs = [(q.astype(np.uint8), t.astype(np.uint8))
                      for q, t in pairs]
        batch, part = wf.GapBatch.of(pairs), np.arange(n)
        card, host = [], []
        al._solve(batch, part, 128, 128, 1, None)
        for _ in range(5):
            t0 = time.perf_counter()
            al._solve(batch, part, 128, 128, 1, None)
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
        log(f"[main] {run} launch groups (route (S_q,S_t): groups, mean "
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
    "groups": {f"{r} ({q},{t})": g[0]
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
    bytes of the plain fill, the q-gram scores of the plain gate (kernel
    ``csrc/qgram.cu``), total == B; then the q-gram kernel against its
    plain version on a batch of 16,384 pairs at W 128, timed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sedef_tpu_torch.ops import wavefront as wf
    from sedef_tpu_torch.parallel import mesh as mesh_mod
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
        mesh_mod.qgram_scores.launches = 0
        p, mcells, qg, total, total_passed, counts = multichip_step(
            mesh, S_q, S_t)(*shard, args[4])
        torch.cuda.synchronize()
        launches = _read_counts()
        launches["qgram_scores"] = mesh_mod.qgram_scores.launches
        STAGE1["qgram_scores"]["launches"] += launches["qgram_scores"]
        if launches["qgram_scores"]:
            STAGE1_PATHS["qgram_scores"].append("multichip_step")
        _compare("qgram_scores", (qg,),
                 (mesh_mod.qgram_scores_torch(shard[2], shard[3]),))
        plain = wf.wavefront_fill_torch(shard[0][:, :S_q].to(torch.int8),
                                        shard[1])
        bad, _ = _band_diff(p, plain, 0, S_q, S_t, 1)
        _require(bad, "multichip_step direction bytes")
        if int(total) != B or int(counts.sum()) != int(total_passed):
            raise AssertionError(f"multichip_step counters: total "
                                 f"{int(total)}, passed {int(total_passed)},"
                                 f" counts {counts.tolist()}")
        _require_launched("multichip_step", launches,
                          ("wavefront_fill", "qgram_scores"))
        log(f"[entry] multichip_step, world of 1 ({dist.get_backend()}) on "
            f"the card, ({S_q},{S_t},{B}): band bytes = plain fill's, qg = "
            f"the plain gate's, total {int(total)}, passed "
            f"{int(total_passed)}, mcells {mcells.tolist()[:4]}..., qg "
            f"{qg.tolist()[:4]}...; launches {launches}")
    finally:
        dist.destroy_process_group()
    rng = np.random.default_rng(13)
    a = rng.integers(0, 4, (16_384, 128)).astype(np.uint8)
    b = a.copy()
    flip = rng.random(a.shape) < 0.1
    b[flip] = rng.integers(0, 4, int(flip.sum()))
    k_ms, p_ms = _time_against_plain(
        "qgram_scores", mesh_mod.qgram_scores, mesh_mod.qgram_scores_torch,
        (torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()), {},
        "16,384 pairs, W 128")
    log(f"[entry] q-gram kernel (csrc/qgram.cu), 16,384 pairs at W 128: "
        f"{k_ms:.3f} ms (CUDA events, median of 3) against the plain "
        f"version's {p_ms:.3f} ms on the card, outputs equal")


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

SORT_OPS = 1.0  # operations a comparison of a sort (n log2 n of them)
SCAN_OPS = 8    # operations an element of the union-rank scan
QG, QSZ = 5, 1024  # the mesh step's q-grams and their bins (ops/filter.py)


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

    def interval_verdicts(q_keys, r_keys, r_locs, limit_lut, plan, L, SQ, RW,
                          SA, n_shift, tile=None, out=None):
        # the plain version's passes: two sketch sorts a row, a span row a
        # row, and a composition row for each of phase B's windows (their
        # count from the records)
        n = plan.shape[1]
        R = int(out[:, 1].sum()) if out is not None and n else 0
        return (2 * _sort_ops(n, SQ) + 4 * n * SQ + _sort_ops(n, SA)
                + _sort_ops(n, SQ + SA) + SCAN_OPS * n * (SQ + SA)
                + _sort_ops(R, RW) + _sort_ops(R, SQ + RW)
                + SCAN_OPS * R * (SQ + RW),
                nb(q_keys, r_keys, r_locs, limit_lut, plan) + 8 * n, (n, R))

    def device_index(code, cls, nk_valid, k, w, cap, drop=0):
        import math
        n = code.shape[0]
        return (n * (3 * k + 2 * math.log2(k) + 2 * math.log2(w) + 12),
                2 * n + 2 * cap * 4 + 4, (n,))

    def roll_batch(r_keys, r_locs, nr, lut, q_keys, qws, qwe, t0, rws0,
                   init_cnt, n_steps, re0, W, SQ, INIT_PAD, T_PAD,
                   n_shift, init_max=None, steps_max=None, out=None):
        # the steps the batch's rows need, a W-wide row pass of ~13
        # element operations for each of the add and the remove a step
        B = qws.shape[0]
        steps = int(init_cnt.clamp(max=INIT_PAD).sum()) \
            + 2 * int(n_steps.clamp(max=T_PAD).sum())
        return (13 * W * steps,
                nb(r_keys, r_locs, q_keys, qws, qwe, t0, rws0, init_cnt,
                   n_steps, re0) + B * 9, (B, W, T_PAD))

    def qgram_scores(codes_a, codes_b):
        # the plain version's two gram passes and its three 1,024-bin
        # passes (the histograms' zeroing, their minimum and its sum)
        W = codes_a.shape[-1]
        P = codes_a.numel() // max(W, 1)
        n = max(W - QG + 1, 0)
        return (P * (2 * n * (2 * QG + 2) + 3 * QSZ),
                nb(codes_a, codes_b) + 4 * P, (P, W))

    return {"_interval_verdicts": interval_verdicts,
            "_device_index": device_index, "_roll_batch": roll_batch,
            "qgram_scores": qgram_scores}


class OpTimer:
    """Wraps the stage-1 device ops in their modules: per op, calls,
    CUDA-event time around each call (its kernels as the host launched
    them), the summed bound of the calls' work, and the largest rows
    shape of a call.  ``record``: the ops whose calls (arguments and
    output) are kept, for a later check against their plain versions.
    An op in ``AFTER`` has its work counted from its arguments and output
    when the timer is read (no wait for the card inside the run)."""

    AFTER = ("_interval_verdicts", "_roll_batch")

    def __init__(self, record=()):
        from sedef_tpu_torch.ops import prefilter, roll_engine, winnow_device
        self.mods = {"_interval_verdicts": prefilter,
                     "_device_index": winnow_device,
                     "_roll_batch": roll_engine}
        self.costs = _op_costs()
        self.record = set(record)
        self.real = {}
        self.reset()

    def reset(self):
        self.events = {n: [] for n in self.mods}
        self.work = {n: [0.0, 0.0] for n in self.mods}
        self.shape = {}
        self.calls = {n: [] for n in self.record}
        self.after = {n: [] for n in self.AFTER}

    def __enter__(self):
        import torch
        for name, mod in self.mods.items():
            real = self.real[name] = getattr(mod, name)

            def wrapped(*a, _n=name, _f=real, **kw):
                if _n not in self.AFTER:
                    self._count(_n, *self.costs[_n](*a, **kw))
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = _f(*a, **kw)
                e1.record()
                self.events[_n].append((e0, e1))
                if _n in self.record:
                    self.calls[_n].append((a, kw, out))
                if _n in self.AFTER:
                    self.after[_n].append((a, kw, out))
                return out

            setattr(mod, name, wrapped)
        return self

    def _count(self, name, ops, nbytes, shape):
        self.work[name][0] += ops
        self.work[name][1] += nbytes
        self.shape[name] = max(self.shape.get(name, shape), shape)

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, self.real[name])

    def read(self) -> dict:
        import torch
        torch.cuda.synchronize()
        for name, calls in self.after.items():
            for a, kw, res in calls:
                self._count(name, *self.costs[name](*a, **{**kw, "out": res}))
            calls.clear()
        out = {}
        for name, evs in self.events.items():
            if evs:
                ops, nbytes = self.work[name]
                out[name] = {"launches": len(evs),
                             "ms": sum(a.elapsed_time(b) for a, b in evs),
                             "shape": self.shape.get(name),
                             **bound(ops, nbytes)}
        return out


# stage 1's kernels: wrapper -> (its CUDA source, the device program it
# replaces)
STAGE1_KERNELS = {
    "_roll_batch": ("sedef_tpu_torch/csrc/roll_engine.cu",
                    "sedef_tpu/ops/roll_engine.py:143"),
    # RollPrefilter.dispatch + collect's flow on the card: its three
    # programs and the host work between them
    "_interval_verdicts": ("sedef_tpu_torch/csrc/prefilter_intervals.cu",
                           "sedef_tpu/ops/prefilter.py:267"),
    "_device_index": ("sedef_tpu_torch/csrc/device_index.cu",
                      "sedef_tpu/ops/winnow_device.py:84"),
    # the mesh step's gate, checked on [entry] (c)'s path
    "qgram_scores": ("sedef_tpu_torch/csrc/qgram.cu",
                     "sedef_tpu/parallel/mesh.py:46"),
}
# per stage-1 kernel: launches on stage 1's paths (each path's run counted
# from 0), the largest difference from the plain version, the rows
# compared, and the times at the shape the summary reports
STAGE1 = {name: {"launches": 0, "max_abs_err": 0, "compared": 0,
                 "library_ms": None} for name in STAGE1_KERNELS}
# the stage-1 paths a kernel must have been launched on
STAGE1_PATHS = {name: [] for name in STAGE1_KERNELS}
# the roll kernel's instantiations: registers and spills (ptxas)
ROLL_PTXAS = {}


def _stage1_wrappers():
    from sedef_tpu_torch.ops import prefilter, roll_engine, winnow_device
    return (prefilter.KERNEL_WRAPPERS + roll_engine.KERNEL_WRAPPERS
            + winnow_device.KERNEL_WRAPPERS)


class _Stage1Path:
    """One run of a stage-1 path: every stage-1 kernel's count set to 0
    before it, read after it and added to STAGE1; ``expect``: the kernels
    the run must have launched."""

    def __init__(self, what, expect):
        self.what, self.expect = what, expect

    def __enter__(self):
        for w in _stage1_wrappers():
            w.launches = 0
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:
            return False
        self.counts = {w.__name__: w.launches for w in _stage1_wrappers()}
        for name, n in self.counts.items():
            STAGE1[name]["launches"] += n
            if n:
                STAGE1_PATHS[name].append(self.what)
        _require_launched(self.what, self.counts, self.expect)
        return False


def _compare(name, got, want):
    """Kernel outputs against the plain version's, equal dtypes and
    values; the largest difference goes into STAGE1."""
    rec = STAGE1[name]
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: {g.dtype} {tuple(g.shape)} != "
                                 f"plain {w.dtype} {tuple(w.shape)}")
        err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["compared"] += g.numel()
        _require(int((g != w).sum()), f"{name} at {tuple(g.shape)}")


def _event_ms(fn, reps=3):
    """Median CUDA-event ms of ``reps`` calls of fn (after one warm-up)
    and its last output."""
    import statistics

    import torch
    out = fn()
    ms = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    return statistics.median(ms), out


def _time_against_plain(name, kernel, plain, args, kw, at):
    """The kernel's and the plain version's CUDA-event ms on the same
    inputs, their outputs compared; the summary's times and bound."""
    k_ms, got = _event_ms(lambda: kernel(*args, **kw))
    p_ms, want = _event_ms(lambda: plain(*args, **kw), reps=1)
    _compare(name, got if isinstance(got, tuple) else (got,),
             want if isinstance(want, tuple) else (want,))
    extra = {"out": want} if name in OpTimer.AFTER else {}
    ops, nbytes, _ = _op_costs()[name](*args, **kw, **extra)
    formula = bound(ops, nbytes)
    STAGE1[name].update(ms=k_ms, plain_ms=p_ms, at=at,
                        **bound(*_least_work(plain, args, kw, want)),
                        bound_formula_ms=formula["bound_ms"],
                        bound_formula_by=formula["bound_by"])
    return k_ms, p_ms


# integer operations a sketch update of a roll needs at the least: its
# cursor's two loads and test, one comparison of the place search, the
# found / flag tests, the boundary read and its comparison, the counter
# and the best-jaccard update (a step where no cursor fires needs none)
UPDATE_OPS = 16
# a k-mer position of the index build, at the least: a rolling pack and
# its mask (3), the status from two running counts (4), a sliding minimum
# in amortised O(1) (3), the change-point test and its masks (3), the
# compaction (3)
INDEX_OPS = 16
# a q-gram: QG shift-ors (2 QG) and a range test, one histogram update
GRAM_OPS = 2 * QG + 2


def _least_work(plain, args, kw, out=None):
    """(ops, bytes) a stage-1 kernel's call needs on these inputs, at the
    least: every input read once and every output written once, and the
    operations the data asks for (a roll: its query sketch, n log2 n
    comparisons and a compaction step for its n keys, and UPDATE_OPS for
    each sketch update its inputs force, ``_roll_updates``; a window-ideal
    row:
    n log2 n comparisons to sort its n keys, a search of the query row
    and a scan element for each; a query sketch: n log2 n comparisons and
    a compaction step for its n gathered keys; the index build:
    INDEX_OPS a k-mer position; the q-gram gate: GRAM_OPS a gram of
    either window; an interval's verdict, ``_interval_work``).
    ``_op_costs`` holds the same calls to a W- or width-wide pass
    instead, the plain versions' work.  ``out``: the plain version's
    output, for the work that depends on it."""
    import inspect
    import math

    import torch
    a = inspect.signature(plain).bind(*args, **kw).arguments

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if t is not None)

    if "plan" in a:
        return _interval_work(a, out)

    if "codes_a" in a:  # q-gram scores: a and b's grams
        W = a["codes_a"].shape[-1]
        P = a["codes_a"].numel() // W
        return (GRAM_OPS * 2 * P * max(W - QG + 1, 0),
                nb(a["codes_a"], a["codes_b"]) + 4 * P)
    if "code" in a:  # the index build: every k-mer position once
        nk = a["code"].shape[0] - a["k"] + 1
        return (INDEX_OPS * nk, nb(a["code"], a["cls"]) + 8 * a["cap"] + 4)
    if "limit_lut" in a and "n_steps" not in a:  # the query sketches
        SQ = a["SQ"]
        n = (a["qwe"] - a["qws"]).clamp(0, SQ).double()
        B = n.shape[0]
        return (float((n * (torch.log2(n.clamp(min=2)) + 1)).sum()),
                nb(a["q_keys"], a["qws"], a["qwe"], a["limit_lut"])
                + B * (4 * SQ + 9))

    if "n_steps" in a:
        n = (a["qwe"] - a["qws"]).clamp(0, a["SQ"]).double()
        sketch = float((n * (torch.log2(n.clamp(min=2)) + 1)).sum())
        cols = [a[c] for c in ("qws", "qwe", "t0", "rws0", "init_cnt",
                               "n_steps", "re0")]
        return (sketch + UPDATE_OPS * float(_roll_updates(a)[1].sum()),
                nb(a["r_keys"], a["r_locs"], a["q_keys"], a["limit_lut"],
                   *cols) + cols[0].shape[0] * 9)
    lo, hi = (a["sa"], a["sb"]) if "sa" in a else (a["a"], a["b"])
    width = a.get("SA", a.get("RW"))
    iv = a.get("iv_id")
    SQ = a["qk_all"].shape[1]
    n = (hi - lo).clamp(min=0).double()
    n = torch.where(hi - lo > width, 0, n)
    ops = float((n * (torch.log2(n.clamp(min=2)) + math.log2(SQ)
                      + SCAN_OPS)).sum())
    q_rows = lo.shape[0] if iv is None else int(torch.unique(iv).numel())
    return (ops, 4 * float(n.sum()) + 4 * q_rows * (SQ + 1)
            + nb(lo, hi, iv) + 4 * lo.shape[0])


def _roll_updates(a):
    """A roll call's sketch updates per interval (its arguments bound by
    name): (counted, performed).  Counted: the init adds and two a step,
    as a roll that visits every step makes them.  Performed: the updates
    its inputs force, the init adds and each cursor's fires, less those
    of HAS_N keys (skipped).  The minimizer loci rise strictly, so the
    remove cursor, which may fire once a step once loc <= t0 + t, fires
    min(n, #loci in [rws0, nr) up to t0 + n - 1) times over n steps; the
    add cursor fires at every locus from re0 to re0 + n - 1, where its
    first locus is not below re0, else never."""
    import numpy as np
    locs = a["r_locs"].cpu().numpy().astype(np.int64)
    keys = a["r_keys"].cpu().numpy()
    nr = int(a["nr"])
    ok_key = np.concatenate(
        [[0], np.cumsum((keys >> a["n_shift"]) != 2)]).astype(np.int64)

    def col(c):
        return a[c].cpu().numpy().astype(np.int64)

    rws0, t0, re0 = col("rws0"), col("t0"), col("re0")
    init = np.clip(col("init_cnt"), 0, a["INIT_PAD"])
    n = np.clip(col("n_steps"), 0, a["T_PAD"])
    live = locs[:nr]

    def real(lo, cnt):  # the non-HAS_N keys among [lo, lo + cnt)
        lo = np.clip(lo, 0, len(keys))
        return ok_key[np.clip(lo + cnt, 0, len(keys))] - ok_key[lo]

    removes = np.minimum(n, np.maximum(
        np.searchsorted(live, t0 + n - 1, side="right") - rws0, 0))
    rwe0 = rws0 + col("init_cnt")
    first = locs[np.clip(rwe0, 0, len(locs) - 1)]
    adds = np.where((rwe0 < nr) & (first >= re0), np.maximum(
        np.searchsorted(live, re0 + n - 1, side="right") - rwe0, 0), 0)
    return (init + 2 * n,
            real(rws0, init) + real(rws0, removes) + real(rwe0, adds))


def _interval_work(a, rec):
    """The least work of a ``_interval_verdicts`` call (its arguments
    bound by name; ``rec`` the plain version's records): each query window
    not past SQ read and sketched (n log2 n comparisons and a compaction
    step for its n keys); for each interval that reached phase A its
    span's keys read and searched in the sketch; for each interval phase B
    pruned its span's loci read and every window sorted and ranked (n
    log2 n comparisons, a search of the sketch and a scan element for each
    of its n keys); for each interval phase B left alive the one window
    that proves it, counted as its t0 window; the plan read and the
    records written."""
    import math

    import torch

    from sedef_tpu_torch.ops import prefilter as pf
    plan, SQ, RW, L = a["plan"], a["SQ"], a["RW"], a["L"]
    qws, qwe, t0, rws0, steps = (c.long() for c in plan)
    locs = a["r_locs"].long()
    code, rows = rec[:, 0], rec[:, 1]
    nq = (qwe - qws).clamp(0, SQ).double()
    nq = torch.where(qwe - qws > SQ, 0, nq)
    ops = float((nq * (torch.log2(nq.clamp(min=2)) + 1)).sum())
    nbytes = 4 * float(nq.sum()) + 20 * plan.shape[1] + 8 * rec.shape[0]
    t1 = t0 + steps
    span_n = (torch.searchsorted(locs, t1 + L) - rws0).clamp(min=0)
    phase_a = ((code == 1) | (rows > 0)) & (span_n <= a["SA"])
    na = float(span_n[phase_a].sum())
    ops += na * math.log2(SQ)
    nbytes += 4 * na

    def rank_ops(n):
        n = torch.where(n > RW, 0, n.clamp(min=0)).double()
        return float((n * (torch.log2(n.clamp(min=2)) + math.log2(SQ)
                           + SCAN_OPS)).sum())

    pruned_b = torch.nonzero(code == 2).flatten()
    _, wa, wb = pf._composition_windows(locs, t0, t1, rws0, span_n,
                                        pruned_b, L)
    ops += rank_ops(wb - wa)
    nbytes += 8 * float(span_n[pruned_b].sum())
    alive = (code == 0) & (rows > 0)
    w0 = (torch.searchsorted(locs, t0[alive] + L)
          - torch.searchsorted(locs, t0[alive]))
    ops += rank_ops(w0)
    nbytes += 8 * float(w0.clamp(min=0).sum())
    return ops, nbytes


# the ops whose every whole-job call is checked against its plain version
RECORDED = ("_interval_verdicts",)


def _check_interval_calls(timer):
    """Every ``_interval_verdicts`` call of a run against its plain
    version on the same CUDA tensors, the largest timed against it.
    Returns calls checked and the spans' shape."""
    import torch

    from sedef_tpu_torch.ops import prefilter as pf
    name = "_interval_verdicts"
    calls = timer.calls.get(name, [])
    spans, b_spans = [], []
    for a, kw, out in calls:
        want = pf._interval_verdicts_torch(*a, **kw)
        _compare(name, (out,), (want,))
        plan = a[4].long()
        end = torch.searchsorted(a[2].long(), plan[2] + plan[4] + kw["L"])
        span_n = (end - plan[3]).clamp(min=0)
        spans.append(span_n)
        b_spans.append(span_n[want[:, 1] > 0])
    done = {name: len(calls)}
    if calls:
        a, kw, out = max(calls, key=lambda c: c[0][4].shape[1])
        if a[4].shape[1] >= STAGE1[name].get("rows", 0):
            STAGE1[name]["rows"] = a[4].shape[1]
            _time_against_plain(name, pf._interval_verdicts,
                                pf._interval_verdicts_torch, a, kw,
                                f"{a[4].shape[1]} intervals, "
                                f"{int(out[:, 1].sum())} composition rows")
    calls.clear()
    return done, _quantiles(spans), _quantiles(b_spans)


def _quantiles(parts) -> dict:
    """Count, median, 90th and 99th percentiles and largest of the values
    in ``parts`` (tensors), and how many exceed the kernel's tile."""
    import torch

    from sedef_tpu_torch.ops import prefilter as pf
    tile = getattr(pf, "INTERVAL_TILE", 1024)  # a tree before the kernel
    v = torch.cat(parts).double() if parts else torch.zeros(0)
    if not v.numel():
        return {"n": 0}
    q = torch.quantile(v, torch.tensor([0.5, 0.9, 0.99], dtype=v.dtype,
                                       device=v.device)).tolist()
    return {"n": v.numel(), "p50": q[0], "p90": q[1], "p99": q[2],
            "max": float(v.max()), "sum": float(v.sum()),
            "past_tile": int((v > tile).sum())}


def _stage1_index(fr, names, k, w, timer):
    """The device index build on both strands of every chromosome against
    the host scan and the stable sort (kernel ``csrc/device_index.cu``),
    then the kernel against its plain version on a first segment (timed),
    a continuation segment and a segment whose emits pass its capacity."""
    import numpy as np
    import torch

    from sedef_tpu_torch.ops import winnow_device as wd
    from sedef_tpu_torch.ops.dna import PackedSeq
    from sedef_tpu_torch.ops.winnow import minimizers
    from sedef_tpu_torch.ops.winnow_device import device_index_arrays
    seqs = [PackedSeq(n, fr.get_sequence(n), is_rc=rc)
            for n in names for rc in (False, True)]
    device_index_arrays(seqs[0].code[:100_000], seqs[0].cls[:100_000], k,
                        w, device="cuda")  # first-call set-up, untimed
    ms, host_ms = [], []
    with _Stage1Path("e2e-20M index", ("_device_index",)) as path, timer:
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
        "and numpy's stable sort): " + ", ".join(f"{m:.3f}" for m in host_ms)
        + f"; kernel launches {path.counts}")
    # segments as _run_segments cuts them, against the plain version
    code = torch.from_numpy(seqs[0].code).cuda()
    cls = torch.from_numpy(seqs[0].cls).cuda()
    seg, n = wd._SEG, code.shape[0]
    nk_seg = seg - k + 1
    cap = nk_seg // 6
    k_ms, p_ms = _time_against_plain(
        "_device_index", wd._device_index, wd._device_index_torch,
        (code[:seg], cls[:seg], nk_seg, k, w, cap, 0), {},
        f"a first segment of {seg} codes")
    lo = nk_seg - w
    hi = min(lo + seg, n)
    homo = torch.full((seg,), 3, dtype=torch.uint8, device="cuda")
    checks = [(code[lo:hi], cls[lo:hi], hi - lo - k + 1, k, w, cap, w),
              (homo, torch.zeros_like(homo), nk_seg, k, w, cap, 0)]
    counts = []
    for args in checks:
        got = wd._device_index(*args)
        _compare("_device_index", got, wd._device_index_torch(*args))
        counts.append(int(got[0]))
    if counts[1] <= cap:
        raise AssertionError("the homopolymer segment stayed within cap")
    log(f"[stage1] index kernel (csrc/device_index.cu) = the plain version "
        f"on a first segment of {seg} codes ({k_ms:.3f} ms, CUDA events, "
        f"median of 3, against the plain version's {p_ms:.3f} ms on the "
        f"card), a continuation segment of {hi - lo} codes (drop {w}, "
        f"{counts[0]} minimizers) and a homopolymer segment past cap "
        f"({counts[1]} emits, cap {cap})")
    return {"card_ms": ms, "host_ms": host_ms, "launches": path.counts,
            "kernel_ms": k_ms, "plain_ms": p_ms}


class PrefilterSplit:
    """The host's time in the prefilter's dispatches while the block runs,
    split by what it does, each part's own time (its callees' taken out):
    plan (the native search plan, every planned pair), upload (``upload``
    calls), launch (calls of the kernel wrappers), pull (copies to the
    host, and waits on the card's events, inside dispatch and collect),
    host rows (``_dispatch_compositions`` where a tree has it: the event
    rows and their bounds on the host), dispatch (the rest of
    ``RollPrefilter.dispatch``) and verdicts (the rest of
    ``PendingPrefilter.collect``); uploads, pulls and their bytes.  It
    wraps names that a tree may lack, so that it times another checkout's
    prefilter (``--prefilter-split``)."""

    def __init__(self):
        import torch

        from sedef_tpu_torch.native import kernels
        from sedef_tpu_torch.native import lib as native
        from sedef_tpu_torch.ops import prefilter as pf
        self.targets = [(native, "search_plan", "plan"),
                        (pf.RollPrefilter, "dispatch", "dispatch"),
                        (pf.PendingPrefilter, "collect", "verdicts"),
                        (kernels, "upload", "upload"),
                        (kernels, "pull", "pull"),
                        (torch.Tensor, "cpu", "pull"),
                        (torch.cuda.Event, "synchronize", "pull"),
                        (pf.RollPrefilter, "_dispatch_compositions", "rows")]
        self.targets += [(pf, w.__name__, "launch")
                         for w in pf.KERNEL_WRAPPERS]
        self.ms = dict.fromkeys(("plan", "upload", "launch", "pull", "rows",
                                 "dispatch", "verdicts"), 0.0)
        self.n = dict.fromkeys(self.ms, 0)
        self.bytes = {"upload": 0, "pull": 0}
        self.pulls = 0
        self.stack = []  # [category, callees' seconds] of the open calls
        self.spans = []  # each dispatch's (L, r_locs, t0, rws0, n_steps)

    def _inside(self) -> bool:
        return any(c in ("dispatch", "verdicts") for c, _ in self.stack)

    def __enter__(self):
        import numpy as np
        self.saved = []
        for obj, name, cat in self.targets:
            if not hasattr(obj, name):
                continue
            self.saved.append((obj, name, obj.__dict__.get(name)))
            real = getattr(obj, name)

            def wrapped(*a, _f=real, _cat=cat, _name=name, **kw):
                if _cat not in ("plan", "dispatch", "verdicts") \
                        and not self._inside():
                    return _f(*a, **kw)
                if _cat == "dispatch":
                    self.spans.append((a[0].L, a[3], a[6], a[7], a[8]))
                self.stack.append([_cat, 0.0])
                t0 = time.perf_counter()
                try:
                    out = _f(*a, **kw)
                finally:
                    dt = time.perf_counter() - t0
                    _, inner = self.stack.pop()
                    self.ms[_cat] += (dt - inner) * 1e3
                    self.n[_cat] += 1
                    if self.stack:
                        self.stack[-1][1] += dt
                if _cat == "upload":
                    self.bytes["upload"] += 4 * np.asarray(a[0]).size
                elif _name in ("cpu", "pull"):
                    t = out if _name == "cpu" else a[0]
                    self.bytes["pull"] += t.numel() * t.element_size()
                    self.pulls += 1
                return out

            setattr(obj, name, wrapped)
        return self

    def __exit__(self, *exc):
        for obj, name, orig in self.saved:
            if orig is None:
                delattr(obj, name)
            else:
                setattr(obj, name, orig)

    def read(self, launches: int) -> dict:
        """Per dispatch: each part's ms, launches, uploads, pulls and
        bytes; and the spans of the planned intervals (their minimizers,
        ``_quantiles``)."""
        import numpy as np
        import torch
        d = max(self.n["dispatch"], 1)
        out = {"dispatches": self.n["dispatch"], "plans": self.n["plan"],
               "launches": launches / d, "uploads": self.n["upload"] / d,
               "pulls": self.pulls / d,
               "upload_bytes": self.bytes["upload"] / d,
               "pull_bytes": self.bytes["pull"] / d}
        out.update({f"{k}_ms": v / d for k, v in self.ms.items()})
        out["plan_ms"] = self.ms["plan"] / max(self.n["plan"], 1)
        spans = []
        for L, locs, t0, rws0, steps in self.spans:
            locs = (locs.cpu().numpy() if isinstance(locs, torch.Tensor)
                    else np.asarray(locs))
            t1 = np.asarray(t0, np.int64) + np.asarray(steps, np.int64)
            spans.append(torch.from_numpy(np.maximum(
                np.searchsorted(locs, t1 + L) - np.asarray(rws0, np.int64),
                0)))
        out["spans"] = _quantiles(spans)
        return out


class RollSplit:
    """The roll engine's calls while the block runs (``RollEngine.run``):
    a call's host ms (its wall, the wait on the card included) and its
    parts, each its own time: upload (``upload``), launch
    (``_roll_batch``), pull (``pull`` and the wait on its event); each
    call's launches, uploads and pulls, their bytes, and the kernel's ms
    summed over the calls: CUDA events recorded just around the kernel's
    launch call (``launch``), so that the wrapper's host work before it
    stays out (the ctypes call and ``cudaLaunchKernel`` stay in, when the
    stream is idle).  ``read``'s ``one_each``: every
    call that rolled an interval on the card made one upload, one launch
    and one pull (a call whose intervals are all past the ladder makes
    none).  It wraps names that a tree may lack, so that
    ``--prefilter-split`` runs in another checkout."""

    COUNTS = ("launches", "uploads", "pulls")

    def __init__(self):
        from sedef_tpu_torch.native import kernels
        from sedef_tpu_torch.ops import roll_engine as re_
        self.re_, self.kernels = re_, kernels
        self.ms = dict.fromkeys(("call", "upload", "launch", "pull"), 0.0)
        self.bytes = {"upload": 0, "pull": 0}
        self.calls = []  # per call: [intervals, launches, uploads, pulls]
        self.events = []

    def __enter__(self):
        import numpy as np
        import torch
        re_, kernels = self.re_, self.kernels
        targets = [(re_.RollEngine, "run", "call"),
                   (kernels, "upload", "upload"), (kernels, "pull", "pull"),
                   (re_, "_roll_batch", "launch"),
                   (kernels, "launch", "kernel"),
                   (torch.cuda.Event, "synchronize", "pull")]
        targets = [t for t in targets if hasattr(t[0], t[1])]
        self.saved = [(obj, name, obj.__dict__.get(name))
                      for obj, name, _ in targets]
        inside = []
        for obj, name, cat in targets:
            real = getattr(obj, name)

            def wrapped(*a, _f=real, _cat=cat, _name=name, **kw):
                if _cat != "call" and not inside:
                    return _f(*a, **kw)
                if _cat == "call":
                    self.calls.append([len(a[6]), 0, 0, 0])
                    inside.append(re_.KERNEL_WRAPPERS[0].launches)
                elif _cat == "kernel":
                    e0 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    out = _f(*a, **kw)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e1.record()
                    self.events.append((e0, e1))
                    return out
                elif _name == "upload":
                    self.calls[-1][2] += 1
                    self.bytes["upload"] += 4 * np.asarray(a[0]).size
                elif _name == "pull":
                    self.calls[-1][3] += 1
                    self.bytes["pull"] += a[0].numel() * a[0].element_size()
                t0 = time.perf_counter()
                try:
                    out = _f(*a, **kw)
                finally:
                    self.ms[_cat] += (time.perf_counter() - t0) * 1e3
                    if _cat == "call":
                        self.calls[-1][1] = (re_.KERNEL_WRAPPERS[0].launches
                                             - inside.pop())
                return out

            setattr(obj, name, wrapped)
        return self

    def __exit__(self, *exc):
        for obj, name, orig in reversed(self.saved):
            if orig is None:
                delattr(obj, name)
            else:
                setattr(obj, name, orig)

    def read(self) -> dict:
        import torch
        torch.cuda.synchronize()
        rolled = [c for c in self.calls if c[1:] != [0, 0, 0]]
        c = max(len(self.calls), 1)
        parts = self.ms["upload"] + self.ms["launch"] + self.ms["pull"]
        return {"calls": len(self.calls), "calls_on_card": len(rolled),
                "one_each": bool(rolled) and all(x[1:] == [1, 1, 1]
                                                 for x in rolled),
                "intervals": sum(x[0] for x in self.calls),
                **{f"{k}_a_call": sum(x[i + 1] for x in self.calls) / c
                   for i, k in enumerate(self.COUNTS)},
                **{f"{k}_bytes_a_call": v / c for k, v in self.bytes.items()},
                **{f"{k}_ms_a_call": v / c for k, v in self.ms.items()},
                "rest_ms_a_call": (self.ms["call"] - parts) / c,
                "kernel_ms_summed": sum(a.elapsed_time(b)
                                        for a, b in self.events)}


def _roll_split_line(name, sp) -> str:
    return (f"[stage1] roll split {name}: {sp['calls']} calls "
            f"({sp['intervals']} intervals, {sp['calls_on_card']} calls with"
            f" intervals on the card, one upload, launch and pull each: "
            f"{sp['one_each']}); a call: {sp['launches_a_call']:.2f} "
            f"launches, "
            f"{sp['uploads_a_call']:.2f} uploads "
            f"({sp['upload_bytes_a_call']:.0f} B), {sp['pulls_a_call']:.2f} "
            f"pulls ({sp['pull_bytes_a_call']:.0f} B); host ms a call "
            f"{sp['call_ms_a_call']:.3f} (upload {sp['upload_ms_a_call']:.3f}"
            f", launch {sp['launch_ms_a_call']:.3f}, pull and its wait "
            f"{sp['pull_ms_a_call']:.3f}, rest "
            f"{sp['rest_ms_a_call']:.3f}); kernel {sp['kernel_ms_summed']:.3f}"
            f" ms summed over the calls (CUDA events around the launch "
            f"call)")


def _split_line(name, sp) -> str:
    return (f"[stage1] prefilter host split {name}: {sp['dispatches']} "
            f"dispatches ({sp['plans']} pairs planned); per dispatch plan "
            f"{sp['plan_ms']:.3f} ms a pair, upload {sp['upload_ms']:.3f} "
            f"ms, launch {sp['launch_ms']:.3f} ms, pull {sp['pull_ms']:.3f} "
            f"ms (the waits on the card included), host rows "
            f"{sp['rows_ms']:.3f} ms, dispatch rest {sp['dispatch_ms']:.3f}"
            f" ms, verdicts {sp['verdicts_ms']:.3f} ms; {sp['launches']:.2f}"
            f" launches, {sp['uploads']:.2f} uploads "
            f"({sp['upload_bytes']:.0f} B), {sp['pulls']:.2f} pulls "
            f"({sp['pull_bytes']:.0f} B) a dispatch; spans (minimizers an "
            f"interval's span) {json.dumps(sp['spans'])}")


def _stage1_whole_job(fr, bins, name, timer):
    """search_stage(jobs=1), the whole-job path, on the card with the
    prefilter forced on and then with the roll engine forced on, each
    against the host route: seeds.bed byte-identical.  The prefilter run's
    host time is split (``PrefilterSplit``) and its kernel calls are
    checked against their plain version afterwards.  ``timer`` None: the
    walls and the split alone (``--prefilter-split``)."""
    import contextlib
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.models import pipeline as pl
    from sedef_tpu_torch.models import seeder
    from sedef_tpu_torch.ops import prefilter
    cache = pl.IndexCache(fr, DEFAULT, use_device="cuda")
    for b in bins:
        for c in b:
            cache.get(c, False)
            cache.get(c, True)
    t0 = time.perf_counter()
    host = pl.search_stage(fr, bins, DEFAULT, use_device=False, jobs=1,
                           cache=cache)
    wall_host = time.perf_counter() - t0
    if not host:
        raise AssertionError(f"{name}: the host route found no seed")
    old = (seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS,
           seeder.ROLL_DEVICE_MIN)
    out = {"wall_host_s": wall_host, "seeds": len(host)}
    for mode in ("prefilter", "roll"):
        split = PrefilterSplit() if mode == "prefilter" else RollSplit()
        if mode == "prefilter":
            seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS = True, 0
            expect = ("_interval_verdicts",) if timer else ()
        else:
            seeder.ROLL_DEVICE_MIN = 0
            expect = ("_roll_batch",)
        prefilter.reset_stats()
        try:
            with _Stage1Path(f"{name} whole-job {mode}", expect) as path, \
                    (timer or contextlib.nullcontext()), \
                    (split or contextlib.nullcontext()):
                t0 = time.perf_counter()
                dev = pl.search_stage(fr, bins, DEFAULT, use_device="cuda",
                                      jobs=1, cache=cache)
                wall_dev = time.perf_counter() - t0
        finally:
            (seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS,
             seeder.ROLL_DEVICE_MIN) = old
        if "\n".join(dev) != "\n".join(host):
            raise AssertionError(f"{name}: seeds.bed with the {mode} "
                                 f"forced on != host route's")
        stats = dict(prefilter.STATS)
        if mode == "prefilter":
            if not stats["intervals"]:
                raise AssertionError(f"{name}: the prefilter ran on no "
                                     f"interval")
            sp = split.read(sum(path.counts.values()))
            log(_split_line(name, sp))
            checked = "not checked"
            if timer:
                checked, spans, b_spans = _check_interval_calls(timer)
                log(f"[stage1] spans {name}: minimizers a span over all "
                    f"planned intervals {json.dumps(spans)}; over the "
                    f"intervals phase B ran on {json.dumps(b_spans)} (tile "
                    f"{prefilter.INTERVAL_TILE} loci)")
                sp["b_spans"] = b_spans
            log(f"[stage1] prefilter {name} (search_stage jobs=1, forced "
                f"on): {stats['intervals']} intervals planned, "
                f"{stats['pruned_a']} pruned in phase A, {stats['pruned_b']}"
                f" in phase B, {stats['rows']} composition rows"
                f"; stage-1 wall {wall_dev:.3f} s on the "
                f"card against {wall_host:.3f} s on the host; {len(host)} "
                f"seeds, seeds.bed = host route's; kernel launches "
                f"{path.counts}, every call's output = its plain version's "
                f"({checked})")
            out["prefilter"] = dict(stats, wall_card_s=wall_dev,
                                    launches=path.counts, split=sp)
        else:
            sp = split.read()
            log(_roll_split_line(f"{name} whole-job", sp))
            if timer and not sp["one_each"]:
                raise AssertionError(f"{name}: a roll call is not one "
                                     f"upload, launch and pull")
            log(f"[stage1] roll engine {name} (search_stage jobs=1, forced "
                f"on: every pair's plan through the roll path): stage-1 wall "
                f"{wall_dev:.3f} s on the card against {wall_host:.3f} s on "
                f"the host; seeds.bed = host route's; kernel launches "
                f"{path.counts}")
            out["roll"] = {"wall_card_s": wall_dev, "launches": path.counts,
                           "split": sp}
    return out


def _stage1_gates(genomes, host, tmp, checks=True):
    """One run_pipeline(jobs=1) of e2e-20M on the card under the gates
    devcal.apply installs: aligned.bed and final.bed = the host route's;
    the prefilter's host time split, every launch of the per-interval
    kernel against its plain version (the stage-1 kernels' main-path
    launches are this run's).  ``checks`` False: the wall and the split
    alone, no bed compared (``--prefilter-split``)."""
    import contextlib

    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.models import seeder
    from sedef_tpu_torch.models.pipeline import run_pipeline
    from sedef_tpu_torch.ops import prefilter
    al = _aligner("card", None)
    prefilter.reset_stats()
    timer = OpTimer(record=RECORDED) if checks else None
    with _Stage1Path("e2e-20M run_pipeline, calibrated gates", ()) as path, \
            (timer or contextlib.nullcontext()), PrefilterSplit() as split:
        t0 = time.perf_counter()
        paths = run_pipeline(genomes["e2e-20M"][0],
                             os.path.join(tmp, "gates"), DEFAULT,
                             nbuckets=16, aligner=al, jobs=1, quiet=True,
                             force=True)
        wall = time.perf_counter() - t0
    for s in ("aligned", "final"):
        if checks and open(paths[s], "rb").read() != host["e2e-20M"][1][s]:
            raise AssertionError(f"gates run: {s}.bed != host route's")
    stats = dict(prefilter.STATS)
    sp = split.read(sum(path.counts.values()))
    if seeder.PREFILTER_ON and stats["intervals"] and checks:
        _require_launched("gates run", path.counts, ("_interval_verdicts",))
    checked = _check_interval_calls(timer)[0] if checks else "not checked"
    for name in STAGE1:
        STAGE1[name]["main_path_launches"] = path.counts.get(name, 0)
    log(_split_line("e2e-20M, calibrated gates", sp))
    log(f"[stage1] calibrated gates (devcal.apply): PREFILTER_ON="
        f"{seeder.PREFILTER_ON} PREFILTER_MIN_STEPS="
        f"{seeder.PREFILTER_MIN_STEPS}; run_pipeline(jobs=1) e2e-20M on the "
        f"card {wall:.3f} s, prefilter on {stats['intervals']} intervals "
        f"({stats['pruned_a'] + stats['pruned_b']} pruned); aligned.bed and "
        f"final.bed = host route's; main-path launches {path.counts}, "
        f"every call = its plain version's ({checked})")
    return {"prefilter_on": seeder.PREFILTER_ON,
            "prefilter_min_steps": seeder.PREFILTER_MIN_STEPS,
            "wall_s": wall, "intervals": stats["intervals"],
            "launches": path.counts, "split": sp}


def _roll_edge_rows(k, w):
    """The roll engine's edge rows, as batch-function columns on a
    soft-masked pair with N runs in both sequences (HAS_N keys): the
    pair's plan rows, an empty query window in each T class, a window of
    more than SQ keys, rows past the 512 class, into the 4,096 class and
    past the ladder."""
    import numpy as np

    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.native import lib as native
    from sedef_tpu_torch.ops.dna import PackedSeq
    from sedef_tpu_torch.ops.index import MinimizerIndex
    rng = np.random.default_rng(9)

    def rand(n, chars="ACGTacgt"):
        return "".join(rng.choice(list(chars), n))

    base = rand(1800)
    mut = "".join(rand(1) if rng.random() < 0.1 else ch for ch in base)
    q = rand(300) + base + "N" * 30 + base[:400]
    r = rand(500) + mut + "N" * 30 + mut[:400] + rand(4800)
    qh = MinimizerIndex(PackedSeq("q", q), k, w)
    rh = MinimizerIndex(PackedSeq("r", r), k, w)
    win, iv = native.search_plan(qh, rh, False, DEFAULT)
    woff = np.repeat(np.arange(len(win)), win[:, 3])
    cols = [win[woff, 1], win[woff, 2], iv[:, 0], iv[:, 2], iv[:, 3],
            iv[:, 4], iv[:, 5]]
    rows = [[int(c[i]) for c in cols] for i in range(len(cols[0]))]
    first = rows[0]
    extra = [[*first[:1], first[0], *first[2:5], n, first[6]]
             for n in (300, 3000)]
    extra.append([first[0], first[0] + 165, *first[2:]])
    extra += [[*first[:5], n, first[6]] for n in (600, 4000, 5000)]
    return qh, rh, [np.asarray(c, np.int32) for c in zip(*(rows + extra))]


def _roll_kernel_checks(qh, seq_len, k, w):
    """The roll kernel against its plain version on the same CUDA tensors:
    a full batch (1,024 intervals) of each T class from ``qh``'s self plan
    (the 512 class also through RollEngine.run on the CPU), and the edge
    rows at the card's capacities and at a store of 64 entries; the 4,096
    batch's times go into the summary."""
    import inspect

    import numpy as np
    import torch

    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.native import lib as native
    from sedef_tpu_torch.ops import roll_engine as re_
    from sedef_tpu_torch.ops.stat_model import relaxed_jaccard_estimate
    lut = np.array([relaxed_jaccard_estimate(s, k, DEFAULT)
                    for s in range(161)], np.int32)
    lut_d = torch.from_numpy(lut).cuda()
    out = {}
    win, iv = native.search_plan(qh, qh, True, DEFAULT)
    woff = np.repeat(np.arange(len(win)), win[:, 3])
    cols = [np.asarray(c, np.int32) for c in (
        win[woff, 1], win[woff, 2], iv[:, 0], iv[:, 2], iv[:, 3], iv[:, 4],
        iv[:, 5])]
    # the plan's intervals repeated to fill a batch, and the 4,096 class:
    # the same windows rolled over 4,000 steps
    small = np.resize(np.nonzero(cols[5] <= re_.T_PAD_LADDER[0])[0],
                      re_.DEFAULT_BATCH)
    long_ = np.resize(np.nonzero(cols[6] + 4000 < seq_len)[0],
                      re_.DEFAULT_BATCH)
    cols_long = [c[long_].copy() for c in cols]
    cols_long[5][:] = 4000
    dk, dl = qh.device_arrays("cuda")
    eng = re_.RollEngine(k, lut)
    for label, cc, T in (("512", [c[small] for c in cols], 512),
                         ("4096", cols_long, 4096)):
        args = (dk, dl, len(qh.keys), lut_d, dk,
                *[torch.from_numpy(c).cuda() for c in cc])
        kw = dict(W=re_.DEFAULT_W, SQ=re_.DEFAULT_SQ,
                  INIT_PAD=re_.DEFAULT_INIT_PAD, T_PAD=T, n_shift=2 * k)
        k_ms, p_ms = _time_against_plain(
            "_roll_batch", re_._roll_batch, re_._roll_batch_torch, args, kw,
            f"B={len(cc[0])},W={re_.DEFAULT_W},T_PAD={T}")
        msg = ""
        if label == "512":
            run_args = (len(qh.keys), len(qh.seq), *cc)
            got = eng.run(dk, dk, dl, *run_args)
            ck, cl = qh.device_arrays("cpu")
            cpu = eng.run(ck, ck, cl, *run_args)
            if any(not np.array_equal(a, b) for a, b in zip(got, cpu)):
                raise AssertionError("RollEngine.run on the card != CPU")
            msg = "; RollEngine.run on the card = on the CPU"
        ok = re_._roll_batch(*args, **kw)[2].cpu().numpy()
        rolled = int(cc[5][ok].sum())
        # the longest chain's sketch updates: counted (init adds, two a
        # step) and performed (those the inputs force)
        counted, performed = _roll_updates(inspect.signature(
            re_._roll_batch_torch).bind(*args, **kw).arguments)
        chain, done = int(counted.max()), int(performed.max())
        rec = STAGE1["_roll_batch"]
        out[f"batch_{label}"] = {"ms": k_ms, "plain_ms": p_ms,
                                 "ok": int(ok.sum()),
                                 "steps_per_s": rolled / k_ms * 1e3,
                                 "longest_chain_updates": chain,
                                 "longest_chain_performed": done,
                                 "ns_per_counted_update": k_ms * 1e6 / chain,
                                 "ns_per_performed_update":
                                     k_ms * 1e6 / done,
                                 "bound_ms": rec["bound_ms"],
                                 "bound_by": rec["bound_by"],
                                 "bound_formula_ms": rec["bound_formula_ms"]}
        rec[f"ns_per_counted_update_T{T}"] = k_ms * 1e6 / chain
        rec[f"ns_per_performed_update_T{T}"] = k_ms * 1e6 / done
        log(f"[stage1] roll kernel, one batch of {len(cc[0])} x W "
            f"{re_.DEFAULT_W} in the {label} class (the self plan's "
            f"intervals, repeated): {k_ms:.3f} ms (CUDA events, median of "
            f"3) against the plain version's {p_ms:.3f} ms on the card, "
            f"outputs equal; bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} ({int(performed.sum())} sketch updates "
            f"performed of {int(counted.sum())} counted; formula "
            f"{rec['bound_formula_ms']:.4f} ms); {int(ok.sum())} ok, "
            f"{rolled / k_ms * 1e3:.0f} steps/s; the longest chain "
            f"{chain} sketch updates counted, {k_ms * 1e6 / chain:.1f} ns "
            f"an update; the longest performed {done}, "
            f"{k_ms * 1e6 / done:.1f} ns an update{msg}")
    # the edge rows
    eq, er, ec = _roll_edge_rows(k, w)
    eqk, _ = eq.device_arrays("cuda")
    erk, erl = er.device_arrays("cuda")
    eargs = (erk, erl, len(er.keys), lut_d, eqk,
             *[torch.from_numpy(c).cuda() for c in ec])
    cases = []
    for T, W, SQ in ((512, 512, 160), (4096, 512, 160), (4096, 64, 48),
                     (512, 64, 16), (4096, 64, 16)):
        kw = dict(W=W, SQ=SQ, INIT_PAD=re_.DEFAULT_INIT_PAD, T_PAD=T,
                  n_shift=2 * k)
        got = re_._roll_batch(*eargs, **kw)
        want = re_._roll_batch_torch(*eargs, **kw)
        _compare("_roll_batch", got, want)
        cases.append(f"T {T} W {W} SQ {SQ}: "
                     f"{int(want[2].sum())}/{len(ec[0])} ok")
    log(f"[stage1] roll kernel on {len(ec[0])} edge rows (plan rows of a "
        f"soft-masked pair with N runs, empty query windows, a window past "
        f"SQ, rows past 512 / into 4,096 / past the ladder) = the plain "
        f"version: " + "; ".join(cases))
    out["edge"] = cases
    out["merged"] = _roll_merged_check(
        eng, (dk, dk, dl, len(qh.keys), len(qh.seq)), cols, lut_d, k)
    return out


def _roll_merged_check(eng, arrays, cols, lut_d, k):
    """``RollEngine.run`` on the card over a full batch of the self plan's
    intervals at n_steps drawn from 1-4,096 (and a few past the ladder):
    one launch over both T classes, longest first, per interval equal to
    the plain version batched by class on the card."""
    import numpy as np
    import torch

    from sedef_tpu_torch.ops import roll_engine as re_
    rng = np.random.default_rng(15)
    q_keys, r_keys, r_locs, nr, rlen = arrays
    pick = rng.choice(np.nonzero(cols[6] + 4200 < rlen)[0],
                      re_.DEFAULT_BATCH)
    cc = [c[pick].copy() for c in cols]
    cc[5][:] = rng.integers(1, re_.T_PAD_LADDER[-1] + 1, len(pick))
    cc[5][:4] = [re_.T_PAD_LADDER[-1] + 1, 512, 513, 4096]
    before = re_._roll_batch.launches
    t0 = time.perf_counter()
    got = eng.run(q_keys, r_keys, r_locs, nr, rlen, *cc)
    wall = time.perf_counter() - t0
    launches = re_._roll_batch.launches - before
    if launches != 1:
        raise AssertionError(f"the merged roll call made {launches} launches")
    classes = re_._t_classes(cc[5])
    for T in re_.T_PAD_LADDER:
        sel = classes == T
        want = re_._roll_batch_torch(
            r_keys, r_locs, nr, lut_d, q_keys,
            *[torch.from_numpy(c[sel]).cuda() for c in cc],
            W=re_.DEFAULT_W, SQ=re_.DEFAULT_SQ,
            INIT_PAD=re_.DEFAULT_INIT_PAD, T_PAD=T, n_shift=2 * k,
            steps_max=int(cc[5][sel].max()))
        _compare("_roll_batch", [torch.from_numpy(g[sel]) for g in got],
                 [w.cpu() for w in want])
    if got[2][classes == 0].any():
        raise AssertionError("an interval past the ladder rolled on the "
                             "card")
    n = {T: int((classes == T).sum()) for T in (*re_.T_PAD_LADDER, 0)}
    log(f"[stage1] roll kernel, one merged call (RollEngine.run) over "
        f"{len(pick)} intervals of n_steps 1-{re_.T_PAD_LADDER[-1] + 1} "
        f"(classes {n}): 1 launch, {wall * 1e3:.3f} ms with its upload "
        f"and pull; per interval = the plain version batched by class")
    return {"classes": n, "launches": launches, "wall_ms": wall * 1e3}


def _stage1_roll(fa, timer, k, w):
    """The roll engine forced on, then the prefilter forced on, for one
    whole chromosome of the dense genome against itself and its reverse
    complement: seeds = the host route's; every launch of the prefilter's
    kernel against its plain version."""
    import torch

    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.io.fasta import FastaReference
    from sedef_tpu_torch.models import seeder
    from sedef_tpu_torch.ops import prefilter
    from sedef_tpu_torch.ops import roll_engine as re_
    from sedef_tpu_torch.ops.dna import PackedSeq
    from sedef_tpu_torch.ops.index import MinimizerIndex
    fr = FastaReference(fa)
    name = fr.order[0]
    seq = fr.get_sequence(name)
    qh = MinimizerIndex(PackedSeq(name, seq), k, w)
    rc = MinimizerIndex(PackedSeq(name, seq, is_rc=True), k, w)
    out = {"chromosome": name, "bp": len(seq), "pairs": []}
    old = seeder.ROLL_DEVICE_MIN
    real = seeder._device_roll_results
    for rh, same in ((qh, True), (rc, False)):
        t0 = time.perf_counter()
        host = seeder.initial_search(qh, rh, same, DEFAULT,
                                     use_device=False)
        wall_host = time.perf_counter() - t0
        seen = []

        def spy(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = real(*a)
            seen.append((a[2], res, time.perf_counter() - t))
            return res

        seeder.ROLL_DEVICE_MIN = 0
        seeder._device_roll_results = spy
        try:
            with _Stage1Path(f"{name} roll engine", ("_roll_batch",)) \
                    as path, timer, RollSplit() as split:
                t0 = time.perf_counter()
                dev = seeder.initial_search(qh, rh, same, DEFAULT,
                                            use_device="cuda")
                wall_dev = time.perf_counter() - t0
        finally:
            seeder.ROLL_DEVICE_MIN = old
            seeder._device_roll_results = real
        sp = split.read()
        if not sp["one_each"]:
            raise AssertionError(f"roll engine {name}: a roll call is not "
                                 f"one upload, launch and pull")
        if [h.to_bed() for h in dev] != [h.to_bed() for h in host]:
            raise AssertionError(f"roll engine {name} rc={rh.seq.is_rc}: "
                                 f"seeds != host route's")
        if len(seen) != 1:
            raise AssertionError(f"roll engine {name}: {len(seen)} device "
                                 f"rolls, not one")
        plan, res, wall_roll = seen[0]
        steps = plan[1][:, 4]
        tclass = re_._t_classes(steps)
        classes = {T: int((tclass == T).sum())
                   for T in (*re_.T_PAD_LADDER, 0)}
        rolled = int(steps[res[2]].sum())
        pair = {"rc": rh.seq.is_rc, "intervals": len(steps),
                "classes": classes, "ok": int(res[2].sum()),
                "steps_rolled": rolled, "roll_wall_s": wall_roll,
                "steps_per_s": rolled / wall_roll, "seeds": len(host),
                "search_wall_card_s": wall_dev,
                "search_wall_host_s": wall_host,
                "launches": path.counts["_roll_batch"], "split": sp}
        out["pairs"].append(pair)
        other = "its reverse complement" if rh.seq.is_rc else "itself"
        log(_roll_split_line(f"{name} vs {other}", sp))
        log(f"[stage1] roll engine {name} ({len(seq)} bp, the dense "
            f"genome's first chromosome) vs {other}: "
            f"{len(steps)} intervals (T classes {classes}), {pair['ok']} "
            f"rolled on the card in {pair['launches']} launches ({rolled} "
            f"steps in {wall_roll:.3f} s with the copies = "
            f"{pair['steps_per_s']:.0f} steps/s); initial_search "
            f"{wall_dev:.3f} s with the roll on the card against "
            f"{wall_host:.3f} s on the host; {len(host)} seeds = host "
            f"route's")

        ptimer = OpTimer(record=RECORDED)
        prior = seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS
        seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS = True, 0
        prefilter.reset_stats()
        try:
            with _Stage1Path(f"{name} prefilter", ("_interval_verdicts",)), \
                    ptimer:
                t0 = time.perf_counter()
                pre = seeder.initial_search(qh, rh, same, DEFAULT,
                                            use_device="cuda")
                wall_pre = time.perf_counter() - t0
        finally:
            seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS = prior
        if [h.to_bed() for h in pre] != [h.to_bed() for h in host]:
            raise AssertionError(f"prefilter {name} rc={rh.seq.is_rc}: "
                                 f"seeds != host route's")
        stats = dict(prefilter.STATS)
        checked = _check_interval_calls(ptimer)[0]
        pair["prefilter"] = dict(stats, search_wall_card_s=wall_pre)
        log(f"[stage1] prefilter {name} vs "
            f"{'its reverse complement' if rh.seq.is_rc else 'itself'} "
            f"(initial_search, forced on): {stats['intervals']} intervals, "
            f"{stats['pruned_a']} pruned in phase A, {stats['pruned_b']} in "
            f"phase B, {stats['rows']} composition rows; {wall_pre:.3f} s "
            f"on the card against {wall_host:.3f} s on the host; seeds = "
            f"host route's; every launch = its plain version's ({checked})")
    return out


def phase_stage1(genomes, host, tmp, dense_fa):
    """Stage 1's device engines on the main path's genomes, each held
    against the host route, and their kernels against their plain
    versions (``[stage1]`` lines and one JSON line)."""
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.io.fasta import FastaReference, generate_translation
    from sedef_tpu_torch.ops.dna import PackedSeq
    from sedef_tpu_torch.ops.index import MinimizerIndex
    t_phase = time.perf_counter()
    k, w = DEFAULT.search.kmer_size, DEFAULT.search.window_size
    timer = OpTimer(record=RECORDED)
    summary = {}
    fr = FastaReference(genomes["e2e-20M"][0])
    bins = generate_translation(fr)
    names = [c for b in bins for c in b]
    summary["index"] = _stage1_index(fr, names, k, w, timer)
    summary["e2e-20M"] = _stage1_whole_job(fr, bins, "e2e-20M", timer)
    ops = timer.read()  # the e2e-20M whole-job runs' ops
    frm = FastaReference(genomes["mosaic-20M"][0])
    summary["mosaic-20M"] = _stage1_whole_job(
        frm, generate_translation(frm), "mosaic-20M",
        OpTimer(record=RECORDED))
    summary["gates"] = _stage1_gates(genomes, host, tmp)
    roll_timer = OpTimer()
    summary["roll"] = _stage1_roll(dense_fa, roll_timer, k, w)
    ops["dense roll"] = roll_timer.read().get("_roll_batch")
    seq = fr.get_sequence(names[0])
    qh = MinimizerIndex(PackedSeq(names[0], seq), k, w)
    summary["roll_kernel"] = _roll_kernel_checks(qh, len(seq), k, w)
    summary["ops"] = ops
    for name, o in ops.items():
        log(f"[stage1] op {name}: {o['launches']} calls, {o['ms']:.3f} ms "
            f"(CUDA events), bound {o['bound_ms']:.4f} ms by "
            f"{o['bound_by']}, largest rows shape {o['shape']}")
    summary["sanitizer"] = _sanitize_interval_kernel()
    missing = [n for n, paths in STAGE1_PATHS.items() if not paths]
    if missing:
        raise AssertionError(f"stage 1's paths launched no {missing}")
    unheld = [n for n, rec in STAGE1.items() if not rec["compared"]]
    if unheld:
        raise AssertionError(f"{unheld} never held against their plain "
                             f"versions")
    for name, rec in STAGE1.items():
        log(f"[stage1] kernel {name} ({STAGE1_KERNELS[name][0]}): "
            f"{rec['launches']} launches on {STAGE1_PATHS[name]}; "
            f"{rec['compared']} outputs = the plain version's (max abs err "
            f"{rec['max_abs_err']}); {rec['ms']:.3f} ms against plain "
            f"{rec['plain_ms']:.3f} ms at {rec['at']}, bound "
            f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} (the work "
            f"these inputs need; the op lines' formula, the plain "
            f"version's row passes: {rec['bound_formula_ms']:.4f} ms)")
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[stage1] phase took {summary['phase_s']:.1f}s")
    log("[stage1] " + json.dumps(summary, default=str))
    return summary


# ---------------------------------------------------------------------------
# The per-interval kernel under compute-sanitizer
# ---------------------------------------------------------------------------

SANITIZER_TOOLS = ("memcheck", "racecheck")
SANITIZER_TIMEOUT = 240  # seconds a tool's run may take


def _interval_world(rng, n, n_r, RW):
    """Ref loci with wide gaps (spans of no loci), keys from a small
    alphabet with HAS_N keys and duplicate runs, query keys sharing them,
    and plan columns with n_steps 0, long spans, query windows past SQ,
    empty and reversed ones (the card tests' world, smaller).  As CUDA
    int32 tensors (q_keys, r_keys, r_locs, cols)."""
    import numpy as np
    import torch
    gaps = rng.integers(1, 10, n_r)
    gaps[::97] = 500
    r_locs = np.cumsum(gaps)
    alphabet = rng.choice(1 << 20, 64, replace=False)
    r_keys = rng.choice(alphabet, n_r)
    r_keys[::5] = (2 << 24) | (r_keys[::5] & 0xffff)
    r_keys[500:900:2] = alphabet[3]
    q_keys = rng.choice(alphabet, 5000)
    q_keys[::7] = r_keys[:5000:7]
    t0 = rng.integers(0, int(r_locs[-1]) - 3000, n)
    n_steps = rng.integers(0, 400, n)
    n_steps[::5] = 0
    n_steps[1::9] = 2500
    qws = rng.integers(0, 4800, n)
    qwe = qws + rng.integers(1, 120, n)
    qwe[2::11] = qws[2::11] + 200
    qwe[3::13] = qws[3::13]
    cols = np.stack([qws, qwe, t0, np.searchsorted(r_locs, t0), n_steps])
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
                 for a in (q_keys, r_keys, r_locs, cols))


def interval_probe() -> int:
    """``--interval-probe``: the per-interval kernel on a small plan at
    the kernel's tile and at a 3-loci tile with RW 6 (bounds outside the
    stage), each launch against the plain version; the process a
    sanitizer runs."""
    import numpy as np
    import torch

    from sedef_tpu_torch.ops import prefilter as pf
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    rng = np.random.default_rng(5)
    lut = torch.minimum(torch.arange(321, dtype=torch.int32) // 5 + 1,
                        torch.tensor(12, dtype=torch.int32)).cuda()
    for tile, RW, SA in ((pf.INTERVAL_TILE, 192, 1024), (3, 6, 12)):
        q_keys, r_keys, r_locs, cols = _interval_world(rng, 96, 6000, RW)
        kw = dict(L=40, SQ=160, RW=RW, SA=SA, n_shift=24)
        got = pf._interval_verdicts(q_keys, r_keys, r_locs, lut, cols,
                                    tile=tile, **kw)
        torch.cuda.synchronize()
        want = pf._interval_verdicts_torch(q_keys, r_keys, r_locs, lut,
                                           cols, **kw)
        if not torch.equal(got, want):
            print(f"[probe] records differ at tile {tile}", flush=True)
            return 1
    print("[probe] ok: 2 launches = the plain version", flush=True)
    return 0


def _sanitizer_path():
    """compute-sanitizer beside nvcc (the CUDA toolkit's), or None."""
    import shutil

    from sedef_tpu_torch.native.build import nvcc_path
    bin_dir = os.path.dirname(nvcc_path())
    for cand in (os.path.join(bin_dir, "compute-sanitizer"),
                 os.path.join(os.path.dirname(bin_dir), "compute-sanitizer",
                              "compute-sanitizer")):
        if os.access(cand, os.X_OK):
            return cand
    return shutil.which("compute-sanitizer")


def _sanitize_interval_kernel() -> dict:
    """``--interval-probe`` under compute-sanitizer's memcheck and
    racecheck at once, filtered to the per-interval kernel where the tool
    takes a kernel filter.  A tool that reports an error or a hazard, or a
    probe whose records differ, fails the phase; a tool that is absent, or
    that refuses the card ("Device not supported": the probe's first
    allocation then fails and no kernel runs), is printed as not run."""
    import re
    exe = _sanitizer_path()
    if exe is None:
        log("[stage1] sanitizer: no compute-sanitizer beside nvcc; memcheck "
            "and racecheck of csrc/prefilter_intervals.cu not run")
        return {"run": False}
    helptext = subprocess.run([exe, "--help"], capture_output=True,
                              text=True, timeout=60).stdout
    filt = (["--kernel-name", "kns=prefilter_intervals"]
            if "--kernel-name" in helptext else [])
    t0 = time.perf_counter()
    procs = {tool: subprocess.Popen(
        [exe, "--tool", tool, *filt, "--error-exitcode", "7",
         sys.executable, os.path.abspath(__file__), "--interval-probe"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for tool in SANITIZER_TOOLS}
    out = {}
    for tool, proc in procs.items():
        try:
            text, _ = proc.communicate(timeout=SANITIZER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
                p.communicate()
            raise AssertionError(f"compute-sanitizer {tool} over "
                                 f"{SANITIZER_TIMEOUT} s")
        tail = " | ".join(text.strip().splitlines()[-6:])
        if "[probe] records differ" in text:
            raise AssertionError(f"{tool} probe: records differ: {tail}")
        refusal = [ln.strip("= ") for ln in text.splitlines()
                   if "Error: Device not supported" in ln]
        if refusal and "[probe] ok" not in text:
            log(f"[stage1] sanitizer {tool}: not run, the tool refuses this "
                f"card: {refusal[0]}")
            out[tool] = {"run": False, "refusal": refusal[0]}
            continue
        summary = [ln for ln in text.splitlines() if "SUMMARY" in ln]
        if not summary:
            raise AssertionError(f"compute-sanitizer {tool} gave no summary "
                                 f"(exit {proc.returncode}): {tail}")
        counts = [int(c) for c in re.findall(
            r"(\d+) (?:errors?|hazards?|warnings?)", summary[-1])]
        if proc.returncode or any(counts) or "[probe] ok" not in text:
            raise AssertionError(f"compute-sanitizer {tool} on "
                                 f"csrc/prefilter_intervals.cu (exit "
                                 f"{proc.returncode}): {tail}")
        out[tool] = {"run": True, "summary": summary[-1].strip("= ")}
        log(f"[stage1] sanitizer {tool} on csrc/prefilter_intervals.cu "
            f"({' '.join(filt) or 'every kernel'}; a 96-interval plan at "
            f"the kernel's tile and at tile 3, RW 6): "
            f"{out[tool]['summary']}")
    log(f"[stage1] sanitizer runs took {time.perf_counter() - t0:.1f}s")
    return out


def prefilter_split() -> int:
    """``--prefilter-split``: the card, the build, both 20 Mbp genomes'
    whole-job stage 1 on the host route, with the prefilter forced on
    (its host time split) and with the roll engine forced on, and the
    calibrated-gates run, with no check beyond seeds equal to the host
    route's: the prefilter's host split of the checkout whose package
    sits beside this script (copy the script into a checkout whose
    package has ``native/kernels.py`` and run it there)."""
    from sedef_tpu_torch.io.fasta import FastaReference, generate_translation
    phase_device()
    phase_build()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        genomes = _genomes(tmp)
        for name in ("e2e-20M", "mosaic-20M"):
            fr = FastaReference(genomes[name][0])
            out[name] = _stage1_whole_job(fr, generate_translation(fr), name,
                                          None)
        out["gates"] = _stage1_gates(genomes, None, tmp, checks=False)
    log("[split] " + json.dumps(out, default=str))
    return 0


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
    the wrappers (``kernels.launch`` wrapped while the block runs, no
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

        from sedef_tpu_torch.native import kernels
        self.kernels, self.launch = kernels, kernels.launch
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
        kernels.launch = timed
        return self

    def __exit__(self, *exc):
        self.kernels.launch = self.launch

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
    return "; ".join(
        f"{route} ({S_q},{S_t}): {n}, {total / n:.3g} / {most}"
        for (route, S_q, S_t), (n, total, most) in sorted(
            getattr(al, "launch_groups", {}).items()))


def dense_genome(tmp, mbp):
    """The dense recipe's genome at ``mbp`` Mbp on DENSE_CHROMS
    chromosomes: (FASTA path, work directory)."""
    from sedef_tpu_torch.tools import rehearsal
    work = os.path.join(tmp, "dense")
    t0 = time.perf_counter()
    fa, planted = rehearsal.generate("dense", mbp, work, DENSE_CHROMS)
    spec = rehearsal.spec_of("dense", mbp, DENSE_CHROMS)
    log(f"[dense] {spec}: {planted} planted SDs, made in "
        f"{time.perf_counter() - t0:.1f}s")
    return fa, work


def phase_dense(fa, work, profile=False):
    """The dense genome through ``run_pipeline`` on the card route at the
    calibrated floor, each kernel launch timed by CUDA events (with
    ``profile``: traced by torch.profiler's CUDA activity instead), then
    on the host route: the three beds byte-equal.  Returns the card run's
    launches, per wrapper."""
    import torch

    from sedef_tpu_torch.tools import rehearsal
    t_phase = time.perf_counter()
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
    log(f"[dense] launch groups (route (S_q,S_t): groups, mean / most "
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
    ap.add_argument("--prefilter-split", action="store_true",
                    help="the stage-1 walls and the prefilter's host split "
                         "alone (no result line); runs against the package "
                         "beside the script")
    ap.add_argument("--interval-probe", action="store_true",
                    help="the per-interval kernel on a small plan against "
                         "its plain version (what the sanitizers run)")
    args = ap.parse_args()
    if args.interval_probe:
        return interval_probe()
    if args.prefilter_split:
        return prefilter_split()
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
            dense_fa, dense_work = dense_genome(tmp, args.dense_mbp)
            phase_stage1(genomes, host, tmp, dense_fa)
            dense_launches = phase_dense(dense_fa, dense_work, args.profile)
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
    # stage 1's: launches on stage 1's paths ([stage1] lines)
    kernels += [{"name": name, "route": "cuda", "source": src,
                 "replaces": ref, **{key: STAGE1[name][key] for key in (
                     "launches", "main_path_launches", "max_abs_err", "ms",
                     "plain_ms", "bound_ms", "bound_by", "library_ms", "at",
                     "bound_formula_ms")},
                 "paths": STAGE1_PATHS[name],
                 **({"ptxas": ROLL_PTXAS, **{
                     key: v for key, v in STAGE1[name].items()
                     if key.startswith("ns_per_")}}
                    if name == "_roll_batch" else {})}
                for name, (src, ref) in STAGE1_KERNELS.items()]
    log(f"[smoke] took {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
