"""Counterpart of ``tools/perf_pipeline.py``.

Pipeline scale harness on a synthetic SD genome: each stage run on its
own, its wall time, and the recall of the planted SDs.

    python -m sedef_tpu_torch.tools.perf_pipeline [length] [n_sds]
        [--device cuda|cpu]

``simulate_genome(length, n_sds, seed=1)`` (defaults 5,000,000 bp and 20
SDs) is written to a temporary directory, then stage 1 (``search_stage``,
the whole-job path), stage 2a (``bucket_stage``, 16 buckets), stage 2b
(``align_stage``, 8 region threads) and stage 3 (``stats_rows``) run in
turn.  ``--device cuda`` (the default) aligns on the card at the floors
``devcal`` measures and runs stage 1's device engines there where their
gates let them (it raises without a card); ``--device cpu`` is the host
route (every gap DP on the native scalar DP, stage 1 on the host), the
reference tool's ``--cpu-align``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("length", nargs="?", type=int, default=5_000_000)
    ap.add_argument("n_sds", nargs="?", type=int, default=20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from ..config import DEFAULT
    from ..io.fasta import FastaReference, generate_translation
    from ..models import pipeline as pl
    from ..models import reporter
    from ..models.genome_sim import recall_of, simulate_genome, write_fasta
    from .rehearsal import make_aligner

    al = make_aligner(args.device)
    stage1 = pl.auto_device(al) or False
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        chroms, planted = simulate_genome(args.length, args.n_sds, seed=1)
        fa = os.path.join(tmp, "sim.fa")
        write_fasta(fa, chroms)
        print(f"genome: {args.length/1e6:.1f} Mbp, {len(planted)} planted "
              f"SDs ({time.time()-t0:.1f}s)")

        fr = FastaReference(fa)
        bins = generate_translation(fr)

        t0 = time.time()
        seeds = pl.search_stage(fr, bins, DEFAULT, use_device=stage1)
        t_search = time.time() - t0
        print(f"stage1 search : {t_search:7.1f}s  ({len(seeds)} seeds)")

        t0 = time.time()
        buckets = pl.bucket_stage(seeds, fr, bins, 16, DEFAULT)
        t_bucket = time.time() - t0
        nb = sum(len(b) for b in buckets)
        print(f"stage2a bucket: {t_bucket:7.1f}s  ({nb} regions)")

        t0 = time.time()
        flat = [line for b in buckets for line in b]
        aligned = pl.align_stage(flat, fr, DEFAULT, al, jobs=8)
        aligned = pl.canonical_sort_uniq(aligned)
        t_align = time.time() - t0
        print(f"stage2b align : {t_align:7.1f}s  ({len(aligned)} "
              f"alignments; {al.device_problems} problems on "
              f"{al.device.type})")

        t0 = time.time()
        final = reporter.stats_rows(aligned, fr, DEFAULT)
        final = pl.canonical_sort_uniq(final)
        t_stats = time.time() - t0
        print(f"stage3 stats  : {t_stats:7.1f}s  ({len(final)} final SDs)")

        found = recall_of(final, planted)
        print(f"recall: {found}/{len(planted)}  total wall "
              f"{t_search+t_bucket+t_align+t_stats:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
