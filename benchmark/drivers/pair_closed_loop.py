"""One caller classifying SD pairs one after another through the port's
``simulate.classify_pair`` (jaccard-then-chain: ``seed_align`` on the whole
pair, ``chain_align`` on each combined subrange), with the card's aligner at
``devcal``'s floors, as ``run_pipeline`` installs them.

The pool is walked in its (shuffled) order and again from its start when
the window outlasts it.  Each pair's latency is host-clock time around its
call; the window ends with the last pair started before its seconds have
elapsed.  A sample of the calls, drawn from the seed as the window runs
(reservoir sampling, so that it is uniform over calls however many there
are), keeps what its call returned and the gap DPs it asked for, and so
does the call of the longest pair; the check judges them.
"""

from __future__ import annotations

import random
import sys
import time
import traceback

import numpy as np

from harness import loader
from harness.record import GapDPLog, judge
from reference import cover, rows


class Driver:
    unit = "pair"

    def __init__(self, config: dict, traffic: dict, seed: int, workdir: str,
                 device: str):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        # the sample: (pool index, seed hits, [(sub1, sub2, chain hits)],
        # gap DPs)
        self.records: list[tuple] = []
        self.longest: tuple | None = None
        self.latency: list[float] = []

    def setup(self) -> None:
        from sedef_tpu_torch import devcal
        from sedef_tpu_torch.config import DEFAULT
        from sedef_tpu_torch.models import simulate
        from sedef_tpu_torch.ops.wavefront import WavefrontAligner

        self.simulate = simulate
        self.cfg = DEFAULT
        gen = loader.generator(self.traffic["generator"])
        self.pool = gen.make(self.traffic, self.seed, 0, self.traffic["pool"])
        warm = gen.make(dict(self.traffic, **self.traffic["warmup"]),
                        self.seed, 1, self.traffic["warmup"]["pool"])
        self.aligner = WavefrontAligner(self.cfg, device=self.device)
        print(f"devcal: {devcal.apply(self.aligner)}", file=sys.stderr)
        self.seed_align = simulate.seed_align
        self.chain_align = simulate.chain_align
        for p in warm:
            self._classify(p)

    def record(self) -> None:
        """Keep the gap DPs from here on (after any plant)."""
        self.log = GapDPLog(self.aligner)

    def spans(self) -> list[tuple[object, str, str]]:
        return [(self, "seed_align", "simulate.seed_align"),
                (self, "chain_align", "simulate.chain_align")]

    def _classify(self, p: dict) -> tuple:
        seeds: list = []
        chains: list = []
        cfg, al = self.cfg, self.aligner

        def seed_fn(a, b):
            hits = self.seed_align(a, b, cfg, al)
            seeds.extend(hits)
            return hits

        def chain_fn(a, b):
            hits = self.chain_align(a, b, cfg, al)
            chains.append((a, b, hits))
            return hits

        self.simulate.classify_pair(p["seq1"], p["seq2"], p["error"], cfg,
                                    al, seed_fn=seed_fn, chain_fn=chain_fn)
        return seeds, chains

    def window(self, seconds: float) -> dict:
        attempted = failed = 0
        keep = self.traffic["check_pairs"]
        rng = random.Random(self.seed)
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            k = i % len(self.pool)
            i += 1
            attempted += 1
            self.log.unit = dps = []
            t = time.perf_counter()
            try:
                out = self._classify(self.pool[k])
            except Exception:  # a pair that fails is counted, not fatal
                traceback.print_exc(file=sys.stderr)
                failed += 1
                continue
            self.latency.append(time.perf_counter() - t)
            n = len(self.latency)
            rec = (k, *out, dps)
            if len(self.records) < keep:
                self.records.append(rec)
            else:
                j = rng.randrange(n)
                if j < keep:
                    self.records[j] = rec
            if (self.longest is None or self.pool[k]["length"]
                    > self.pool[self.longest[0]]["length"]):
                self.longest = rec
        self.log.unit = None
        elapsed = time.perf_counter() - t0
        n = len(self.latency)
        return {"attempted": attempted, "failed": failed, "n": n,
                "elapsed_s": elapsed,
                "metrics": {
                    "pairs_per_s": n / elapsed,
                    "pair_ms_p95": 1e3 * float(np.percentile(self.latency,
                                                             95))}}

    def release(self) -> None:
        self.aligner = self.log = None

    def check(self) -> list[dict]:
        """The sampled calls judged by the plain reference: their gap DPs
        (an alignment of their inputs at the optimum score), their chain
        hits (each an alignment of its bases, with its tallies), and how
        much of the low-divergence pairs' copies the seed and chain hits
        cover."""
        limits = self.config["checks"]
        recs = self.records + [r for r in [self.longest] if r is not None
                               and all(r is not x for x in self.records)]
        judged, bad_dp = judge([r[3] for r in recs], self.seed,
                               self.traffic["check_dps"],
                               self.config["scores"])
        bad_hits = 0
        seed_cov = chain_cov = total = 0
        for k, seeds, chains, _ in recs:
            p = self.pool[k]
            for a, b, hits in chains:
                bad_hits += sum(rows.hit_faults(a, b, h) for h in hits)
            if p["error"] > self.config["covered_max_error"]:
                continue
            total += len(p["seq1"]) + len(p["seq2"])
            seed_cov += (
                cover.union_length((h.query_start, h.query_end)
                                   for h in seeds)
                + cover.union_length((h.ref_start, h.ref_end)
                                     for h in seeds))
            # the chained subranges are disjoint on each copy
            for a, b, hits in chains:
                chain_cov += (
                    cover.union_length((h.query_start, h.query_end)
                                       for h in hits)
                    + cover.union_length((h.ref_start, h.ref_end)
                                         for h in hits))
        miss = (lambda c: 100.0 * (1 - c / total)) if total else \
            (lambda c: 100.0)
        values = {"gapdp_suboptimal": bad_dp,
                  "chain_hits_unsound": bad_hits,
                  "seed_missed_pct": miss(seed_cov),
                  "chain_missed_pct": miss(chain_cov)}
        return ([{"name": "pairs_checked", "value": len(recs), "op": ">=",
                  "limit": 1},
                 {"name": "gapdps_checked", "value": judged, "op": ">=",
                  "limit": 1}]
                + [{"name": name, "value": values[name], "op": "<=",
                    "limit": limits[name]} for name in limits])
