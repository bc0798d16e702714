"""Counterpart of ``sedef_tpu/cli.py``.

Command-line interface matching the reference binary's subcommands
(``src/main.cc:133-146``): search | align | stats | translate | pipeline,
plus the WGAC evaluation (``stats diff``, ``check-overlap``, ``pipeline
-W``).  ``--device {cuda,cpu}`` (align generate, pipeline) names the device
of the gap-DP aligner explicitly; ``cuda`` is the default and needs a card.
``pipeline --coordinator host:port --num-processes N --process-id I`` runs
this process's share of every stage in a gloo group of N processes (start
the same command N times, I = 0 .. N-1; process 0 serves the address).

Usage examples (mirroring README.md:124-199 of the reference):

    python -m sedef_tpu_torch.cli search genome.fa chr1 chr1 [-r] [-k 12] [-w 16]
    python -m sedef_tpu_torch.cli search genome.fa 0 1 -t          # super-bin job
    python -m sedef_tpu_torch.cli align bucket seeds.bed out_dir genome.fa -n 1000
    python -m sedef_tpu_torch.cli align generate genome.fa bucket_file -k 11
    python -m sedef_tpu_torch.cli stats generate genome.fa aligned.bed
    python -m sedef_tpu_torch.cli stats diff genome.fa final.bed wgac.tab
    python -m sedef_tpu_torch.cli check-overlap wgac.tab final.bed
    python -m sedef_tpu_torch.cli translate genome.fa
    python -m sedef_tpu_torch.cli pipeline genome.fa -o out_dir    # end-to-end
    python -m sedef_tpu_torch.cli pipeline genome.fa --device cpu  # no card
    python -m sedef_tpu_torch.cli pipeline genome.fa -W wgac.tab   # + report
    python -m sedef_tpu_torch.cli pipeline genome.fa --trace t.json  # spans
    python -m sedef_tpu_torch.cli pipeline genome.fa --coordinator \
        localhost:29500 --num-processes 2 --process-id 0           # and 1
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from .config import Config
from .io.fasta import FastaReference, generate_translation
from .models import pipeline as pl
from .models import reporter
from .ops.wavefront import WavefrontAligner


def _cfg_from_args(args) -> Config:
    cfg = Config()
    if getattr(args, "kmer", None):
        cfg.search.kmer_size = args.kmer
    if getattr(args, "window", None):
        cfg.search.window_size = args.window
    if getattr(args, "error", None) is not None:
        cfg.search.max_error = args.error
    if getattr(args, "edit_error", None) is not None:
        cfg.search.max_edit_error = args.edit_error
    if getattr(args, "gap_freq", None) is not None:
        cfg.search.gap_frequency = args.gap_freq
    cfg.finalize()
    if getattr(args, "uppercase", None):
        cfg.search.min_uppercase = args.uppercase
    return cfg


def cmd_search(args) -> int:
    cfg = _cfg_from_args(args)
    fr = FastaReference(args.fasta)
    if args.translate_bins:
        bins = generate_translation(fr)
        qchrs = bins[int(args.query)]
        rchrs = bins[int(args.ref)]
    else:
        qchrs = [args.query]
        rchrs = [args.ref]
    lines = pl.search_job(fr, qchrs, rchrs, args.reverse, cfg,
                          report_fails=args.report_fails)
    for line in lines:
        print(line)
    print(f"Total: {len(lines)}", file=sys.stderr)
    return 0


def cmd_align(args) -> int:
    cfg = _cfg_from_args(args)
    fr = FastaReference(args.fasta)
    if args.subcmd == "bucket":
        bins = generate_translation(fr)
        paths = ([args.bed] if os.path.isfile(args.bed)
                 else sorted(glob.glob(os.path.join(args.bed, "*.bed"))))
        seed_lines = []
        for p in paths:
            seed_lines.extend(open(p).read().splitlines())
        os.makedirs(args.out_dir, exist_ok=True)
        buckets = pl.bucket_stage(seed_lines, fr, bins, args.bins, cfg,
                                  tmp_dir=args.out_dir)
        for b, lines in enumerate(buckets):
            with open(os.path.join(args.out_dir, f"bucket_{b:04d}"),
                      "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))
        return 0
    # generate
    lines = open(args.bed).read().splitlines()
    out = pl.align_stage(lines, fr, cfg,
                         WavefrontAligner(cfg, device=args.device),
                         kmer_size=args.kmer or 11)
    for line in out:
        print(line)
    print(f"Finished BED {args.bed} ({len(lines)} lines, generated "
          f"{len(out)} hits)", file=sys.stderr)
    return 0


def cmd_stats(args) -> int:
    cfg = _cfg_from_args(args)
    if getattr(args, "max_ok_gap", None) is not None:
        cfg.stats.max_ok_gap = args.max_ok_gap
    if getattr(args, "min_split", None) is not None:
        cfg.stats.min_split_size = args.min_split
    fr = FastaReference(args.fasta)
    lines = open(args.bed).read().splitlines()
    print(reporter.HEADER)
    for row in reporter.stats_rows(lines, fr, cfg):
        print(row)
    return 0


def cmd_diff(args) -> int:
    from .models.evaluate import diff
    fr = FastaReference(args.fasta)
    res = diff(fr, open(args.bed).read().splitlines(),
               open(args.wgac).read().splitlines())
    print(res.report(), file=sys.stderr)
    return 0


def cmd_check_overlap(args) -> int:
    from .models.evaluate import check_overlap
    res = check_overlap(open(args.bed).read().splitlines(),
                        open(args.wgac).read().splitlines())
    print(res.report(), file=sys.stderr)
    return 0


def cmd_translate(args) -> int:
    fr = FastaReference(args.fasta)
    bins = generate_translation(fr)
    for i, b in enumerate(bins):
        print(f" [Translate] {i} -> {', '.join(b)}", file=sys.stderr)
    print(len(bins))
    return 0


def cmd_pipeline(args) -> int:
    if not args.trace:
        return _pipeline(args)
    import json

    from . import trace
    trace.reset()
    trace.enable()
    try:
        return _pipeline(args)
    finally:
        trace.disable()
        with open(args.trace, "w") as f:
            json.dump(trace.snapshot(), f)
        print(f"trace written to {args.trace}", file=sys.stderr)


def _pipeline(args) -> int:
    cfg = _cfg_from_args(args)
    aligner = WavefrontAligner(cfg, device=args.device)
    if args.num_processes:
        # multi-process mode: this process's share of every stage; the
        # group was joined in main(), before anything touched the card
        from .parallel.distributed import run_pipeline_distributed
        paths = run_pipeline_distributed(
            args.fasta, args.output, cfg, nbuckets=args.bins,
            jobs=args.jobs, aligner=aligner, quiet=False, force=args.force)
    else:
        paths = pl.run_pipeline(args.fasta, args.output, cfg,
                                nbuckets=args.bins, jobs=args.jobs,
                                aligner=aligner, quiet=False,
                                force=args.force, wgac=args.wgac)
    print(f"Final SDs available in {paths['final']}", file=sys.stderr)
    if "wgac" in paths:
        print(open(paths["wgac"]).read(), end="", file=sys.stderr)
    return 0


def _banner(device: str) -> None:
    import subprocess

    import torch
    try:
        ver = subprocess.run(["git", "describe", "--always", "--dirty"],
                             capture_output=True, text=True,
                             cwd=os.path.dirname(__file__)).stdout.strip()
    except OSError:
        ver = "unknown"
    if device == "cuda" and torch.cuda.is_available():
        name = (f"cuda: {torch.cuda.get_device_name(0)} "
                f"({torch.cuda.device_count()} device(s))")
    else:
        name = device
    print(f"sedef-tpu-torch {ver or 'unknown'} | torch {torch.__version__}"
          f" | device: {name}", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sedef-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("search", help="stage 1: seed SD search")
    sp.add_argument("fasta")
    sp.add_argument("query")
    sp.add_argument("ref")
    sp.add_argument("-r", "--reverse", action="store_true")
    sp.add_argument("-t", "--translate-bins", action="store_true",
                    help="query/ref are super-bin indices")
    sp.add_argument("-k", "--kmer", type=int, default=12)
    sp.add_argument("-w", "--window", type=int, default=16)
    sp.add_argument("-u", "--uppercase", type=int)
    sp.add_argument("-e", "--error", type=float)
    sp.add_argument("-E", "--edit-error", type=float, dest="edit_error")
    sp.add_argument("-g", "--gap-freq", type=float, dest="gap_freq")
    sp.add_argument("--report-fails", action="store_true",
                    dest="report_fails",
                    help="emit diagnostic rows for gate-rejected windows")
    sp.set_defaults(fn=cmd_search)

    ap = sub.add_parser("align", help="stage 2: bucket / generate")
    asub = ap.add_subparsers(dest="subcmd", required=True)
    ab = asub.add_parser("bucket")
    ab.add_argument("bed")
    ab.add_argument("out_dir")
    ab.add_argument("fasta")
    ab.add_argument("-n", "--bins", type=int, default=1000)
    ab.set_defaults(fn=cmd_align)
    ag = asub.add_parser("generate")
    ag.add_argument("fasta")
    ag.add_argument("bed")
    ag.add_argument("-k", "--kmer", type=int, default=11)
    ag.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the gap-DP aligner")
    ag.set_defaults(fn=cmd_align)

    st = sub.add_parser("stats", help="stage 3: final.bed generation")
    ssub = st.add_subparsers(dest="subcmd", required=True)
    sg = ssub.add_parser("generate")
    sg.add_argument("fasta")
    sg.add_argument("bed")
    sg.add_argument("--max-ok-gap", type=int, dest="max_ok_gap")
    sg.add_argument("--min-split", type=int, dest="min_split")
    sg.set_defaults(fn=cmd_stats)
    sd = ssub.add_parser("diff")
    sd.add_argument("fasta")
    sd.add_argument("bed")
    sd.add_argument("wgac")
    sd.set_defaults(fn=cmd_diff)

    co = sub.add_parser("check-overlap",
                        help="WGAC per-SD Missed/Partial/Full accounting")
    co.add_argument("wgac")
    co.add_argument("bed")
    co.set_defaults(fn=cmd_check_overlap)

    tr = sub.add_parser("translate", help="print super-bin count")
    tr.add_argument("fasta")
    tr.set_defaults(fn=cmd_translate)

    pi = sub.add_parser("pipeline", help="end-to-end search->final.bed")
    pi.add_argument("fasta")
    pi.add_argument("-o", "--output", default="sedef_out")
    pi.add_argument("-n", "--bins", type=int, default=1000)
    pi.add_argument("-k", "--kmer", type=int, default=12)
    pi.add_argument("-w", "--window", type=int, default=16)
    pi.add_argument("-j", "--jobs", type=int, default=1,
                    help="parallel jobs (sedef.sh -j equivalent)")
    pi.add_argument("-f", "--force", action="store_true",
                    help="ignore stage sentinels and recompute")
    pi.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the gap-DP aligner")
    pi.add_argument("-W", "--wgac",
                    help="WGAC tab file: run overlap + diff after final.bed"
                         " (sedef.sh -w)")
    pi.add_argument("--trace", metavar="PATH", default=None,
                    help="record the run's spans and counters and write "
                         "them to PATH as one JSON object at its end")
    pi.add_argument("--coordinator", default=None,
                    help="multi-process mode: host:port of process 0")
    pi.add_argument("--num-processes", type=int, default=0,
                    help="multi-process mode: total process count")
    pi.add_argument("--process-id", type=int, default=None,
                    help="multi-process mode: this process's index")
    pi.set_defaults(fn=cmd_pipeline)

    args = p.parse_args(argv)
    if getattr(args, "num_processes", 0):
        # joins the group (or raises) before anything touches the card
        from .parallel.distributed import init_distributed
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id)
    _banner(getattr(args, "device", "cpu"))
    try:
        return args.fn(args)
    except (KeyError, FileNotFoundError, ValueError) as e:
        # mirror the reference's error -> exit(1) contract (main.cc:147-154)
        print(f"sedef-tpu-torch error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
