"""One analyst, one genome after another: each genome of the pool goes
FASTA -> final.bed through the port's ``run_pipeline`` (a fresh output
directory, so no stage resumes), the next one only when it is done.

The window ends with the last genome started before its seconds have
elapsed; the rate divides the bases of the genomes it finished by the whole
elapsed time.  Genomes drawn from the seed as the window runs (reservoir
sampling over the finished ones) keep the gap DPs they asked for; the check
judges those genomes' rows and gap DPs with the plain reference, and the
coverage of the planted SDs over every genome the window finished.
"""

from __future__ import annotations

import os
import random
import sys
import time
import traceback

from harness import loader
from harness.record import GapDPLog, judge
from reference import cover, rows


def _rows(path: str) -> list[str]:
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if ln.strip() and not ln.startswith("#")]


class Driver:
    unit = "genome"

    def __init__(self, config: dict, traffic: dict, seed: int, workdir: str,
                 device: str):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.workdir = workdir
        self.device = device
        self.kept: list[tuple[int, list]] = []  # (pool index, gap DPs)
        self.done: list[int] = []  # pool indices the window finished

    def setup(self) -> None:
        from sedef_tpu_torch import devcal
        from sedef_tpu_torch.config import DEFAULT
        from sedef_tpu_torch.models import pipeline
        from sedef_tpu_torch.ops.wavefront import WavefrontAligner

        self.pipeline = pipeline
        self.cfg = DEFAULT
        gen = loader.generator(self.traffic["generator"])
        self.pool = gen.make(self.traffic, self.seed, self.workdir, 0,
                             self.traffic["pool"])
        warm_traffic = dict(self.traffic, recipe=dict(
            self.traffic["recipe"], **self.traffic["warmup"]))
        warm = gen.make(warm_traffic, self.seed, self.workdir, 1, 1)
        self.aligner = WavefrontAligner(self.cfg, device=self.device)
        # the warm-up: devcal's calibration, the kernels' library, the
        # first plans
        self._run(warm[0], "warmup")
        print(f"devcal: {devcal.get(self.aligner.device)}", file=sys.stderr)

    def record(self) -> None:
        """Keep the gap DPs from here on (after any plant)."""
        self.log = GapDPLog(self.aligner)

    def _run(self, g: dict, tag: str) -> str:
        out = os.path.join(os.path.dirname(g["fasta"]), f"out_{tag}")
        self.pipeline.run_pipeline(g["fasta"], out, self.cfg,
                                   aligner=self.aligner,
                                   jobs=self.config["settings"]["jobs"],
                                   quiet=True)
        return out

    def spans(self) -> list[tuple[object, str, str]]:
        p = self.pipeline
        return [(p, "search_stage", "pipeline.search_stage"),
                (p.OverlappedTail, "finish", "pipeline.OverlappedTail.finish")]

    def window(self, seconds: float) -> dict:
        attempted = failed = done = 0
        bases = 0
        keep = self.traffic["check_genomes"]
        rng = random.Random(self.seed)
        t0 = time.perf_counter()
        for k, g in enumerate(self.pool):
            if time.perf_counter() - t0 >= seconds:
                break
            attempted += 1
            self.log.unit = dps = []
            t = time.perf_counter()
            try:
                self._run(g, "run")
            except Exception:  # a genome that fails is counted, not fatal
                traceback.print_exc(file=sys.stderr)
                failed += 1
                continue
            done += 1
            self.done.append(k)
            bases += g["bases"]
            if len(self.kept) < keep:
                self.kept.append((k, dps))
            else:
                j = rng.randrange(done)
                if j < keep:
                    self.kept[j] = (k, dps)
            print(f"genome {k}: {g['bases']} bp in "
                  f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
        self.log.unit = None
        elapsed = time.perf_counter() - t0
        if attempted == len(self.pool) and elapsed < seconds:
            print(f"genome pool of {len(self.pool)} ran out before the "
                  "window's end", file=sys.stderr)
        return {"attempted": attempted, "failed": failed, "n": done,
                "elapsed_s": elapsed,
                "metrics": {"genome_kbp_per_s": bases / elapsed / 1e3}}

    def release(self) -> None:
        self.aligner = self.log = None

    def check(self) -> list[dict]:
        """The kept genomes judged by the plain reference: their gap DPs,
        every aligned and final row (an alignment of its bases with the
        tallies and statistics it prints; a final row within the filters);
        and how much of the planted SDs the seeds and the final rows of
        every finished genome cover."""
        limits = self.config["checks"]
        judged, bad_dp = judge([dps for _, dps in self.kept], self.seed,
                               self.traffic["check_dps"],
                               self.config["scores"])
        bad_aligned = bad_final = 0
        for k, _ in sorted(self.kept):
            g = self.pool[k]
            genome = rows.read_fasta(g["fasta"])
            out = os.path.join(os.path.dirname(g["fasta"]), "out_run")
            bad_aligned += sum(rows.aligned_row_faults(ln, genome) for ln in
                               _rows(os.path.join(out, "aligned.bed")))
            bad_final += sum(rows.final_row_faults(
                ln, genome, self.config["filters"])
                for ln in _rows(os.path.join(out, "final.bed")))
        covered = {"seeds": 0, "final": 0}
        total = 0
        for k in self.done:
            g = self.pool[k]
            out = os.path.join(os.path.dirname(g["fasta"]), "out_run")
            for name in covered:
                c, total_g = cover.planted_coverage(
                    _rows(os.path.join(out, f"{name}.bed")), g["planted"])
                covered[name] += c
            total += total_g
        miss = {n: 100.0 * (1 - c / total) if total else 100.0
                for n, c in covered.items()}
        values = {"gapdp_suboptimal": bad_dp,
                  "aligned_rows_unsound": bad_aligned,
                  "final_rows_unsound": bad_final,
                  "seed_missed_pct": miss["seeds"],
                  "final_missed_pct": miss["final"]}
        return ([{"name": "genomes_checked", "value": len(self.kept),
                  "op": ">=", "limit": 1},
                 {"name": "gapdps_checked", "value": judged, "op": ">=",
                  "limit": 1}]
                + [{"name": name, "value": values[name], "op": "<=",
                    "limit": limits[name]} for name in limits])
