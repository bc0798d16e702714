"""Counterpart of ``tools/hg19_dense_rehearsal.py`` and of the genome and
pipeline part of ``tools/hg19_rehearsal.py``.

Scale rehearsal: a simulated genome at a recipe's seed density, run end
to end through ``run_pipeline``, with per-stage walls, row counts and seed
density, and what the card did, in one JSON report.

    python -m sedef_tpu_torch.tools.rehearsal [--recipe dense|sparse]
        [--mbp N] [--chroms N] [--jobs N] [--nbuckets N]
        [--device cuda|cpu] [--work DIR] [--fresh]

Recipes (the ``simulate_genome`` arguments of the two tools, seed 1905):

- ``dense``: hg19 seed density (``tools/hg19_dense_rehearsal.py``): one
  planted SD of 1.3-20 Kbp per 120 Kbp and 150 repeat families x 90
  copies per 50 Mbp, which gives 0.70 seeds/Kbp; by default
  max(2, round(Mbp / 125)) chromosomes, ``--chroms 2`` is
  ``tools/dense_parity.py``'s genome;
- ``sparse``: the first rehearsal's genome (``tools/hg19_rehearsal.py``):
  25,000 planted SDs and 500 repeat families x 25 copies at any size, 24
  chromosomes by default.

The genome and the pipeline's outputs go under ``--work`` (a temporary
directory by default, removed at the end); a genome already there with the
same spec is reused unless ``--fresh``.  ``--device cuda`` (the default)
aligns on the card at the floors ``devcal`` measures, and raises without
one; ``--device cpu`` is the host route: every gap DP on the native scalar
DP, stage 1 on the host.  The report (printed, and written to
``<work>/report.json``) has the reference tool's fields (``spec``,
``jobs``, ``wall_s``, ``stage_s``, ``rows``, ``seeds_per_kbp``) and, where
that tool recorded its device breaker (which the port does not have), the
device, the card's name and power limit (null on the CPU), the aligner's
problems, cells and launch groups on the card, and the launches of every
kernel wrapper.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stderr

SEED = 1905
# density calibration of the dense recipe (the reference's pilots at 50
# and 100 Mbp): 150 families x 90 copies per 50 Mbp, one SD per 120 Kbp
FAMS_PER_50M = 150
COPIES = 90
SPARSE_SDS = 25_000
SPARSE_FAMS = 500
SPARSE_COPIES = 25
SPARSE_CHROMS = 24
RECIPES = ("dense", "sparse")
STAGES = ("search", "bucket", "align", "stats")


def default_chroms(recipe: str, length: int) -> int:
    if recipe == "dense":
        return max(2, round(length / 125_000_000))
    return SPARSE_CHROMS


def recipe_kwargs(recipe: str, length: int,
                  n_chroms: int | None = None) -> dict:
    """The ``simulate_genome`` keyword arguments of ``recipe`` at
    ``length`` bp."""
    if n_chroms is None:
        n_chroms = default_chroms(recipe, length)
    common = dict(length=length, sd_min=1300, sd_max=20_000,
                  max_divergence=0.12, rc_fraction=0.3, n_chroms=n_chroms,
                  seed=SEED, n_run_every=997_000, repeat_len=(500, 2500),
                  repeat_div=(0.08, 0.40))
    if recipe == "dense":
        return dict(common, n_sds=length // 120_000,
                    repeat_families=round(FAMS_PER_50M * length
                                          / 50_000_000),
                    repeat_copies=COPIES)
    if recipe == "sparse":
        return dict(common, n_sds=SPARSE_SDS, repeat_families=SPARSE_FAMS,
                    repeat_copies=SPARSE_COPIES)
    raise ValueError(f"unknown recipe {recipe!r}")


def spec_of(recipe: str, mbp: float, n_chroms: int | None = None) -> str:
    """The genome's name as the reference's reports give it, e.g.
    ``sim(100Mbp,2chr,dense:fams300x90,seed1905)``."""
    kw = recipe_kwargs(recipe, int(mbp * 1_000_000), n_chroms)
    head = f"sim({mbp:g}Mbp,{kw['n_chroms']}chr,"
    if recipe == "dense":
        return (head + f"dense:fams{kw['repeat_families']}x{COPIES},"
                f"seed{SEED})")
    return (head + f"sds{SPARSE_SDS},fams{SPARSE_FAMS}x{SPARSE_COPIES},"
            f"seed{SEED})")


def generate(recipe: str, mbp: float, work: str,
             n_chroms: int | None = None, fresh: bool = False
             ) -> tuple[str, int]:
    """Write the recipe's genome to ``<work>/genome.fa`` (and its .fai);
    returns (its path, the number of planted SDs).  A genome of the same
    spec already there is kept unless ``fresh``."""
    from ..io.fasta import write_fai
    from ..models.genome_sim import simulate_genome, write_fasta
    os.makedirs(work, exist_ok=True)
    fa = os.path.join(work, "genome.fa")
    meta = os.path.join(work, "genome.json")
    spec = spec_of(recipe, mbp, n_chroms)
    if not fresh and os.path.exists(fa + ".fai") and os.path.exists(meta):
        with open(meta) as f:
            known = json.load(f)
        if known["spec"] == spec:
            return fa, known["planted"]
    chroms, planted = simulate_genome(
        **recipe_kwargs(recipe, int(mbp * 1_000_000), n_chroms))
    write_fasta(fa, chroms)
    write_fai(fa)
    with open(meta, "w") as f:
        json.dump({"spec": spec, "planted": len(planted)}, f)
    return fa, len(planted)


def make_aligner(device: str):
    """The aligner of a route: on ``cuda`` the card's, at the floors
    ``devcal`` measures (as ``run_pipeline`` installs them); on ``cpu`` the
    host route, every gap DP on the native scalar DP (a plain cpu aligner
    would send bulk batches to the kernels' plain PyTorch versions)."""
    from .. import devcal
    from ..config import DEFAULT
    from ..ops import wavefront as wf
    al = wf.WavefrontAligner(DEFAULT, device=device)
    if al.device.type == "cpu":
        al.DEVICE_BATCH_MIN = sys.maxsize
    devcal.apply(al)
    return al


def card_info() -> dict | None:
    """The card's name and power limit as ``nvidia-smi`` gives them; None
    where the route has no card."""
    import torch
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (s.strip() for s in out.split(",", 1))
    return {"name": name, "power_limit": limit}


def stage_walls(log: str) -> dict:
    """Stage walls (s) from ``run_pipeline(quiet=False)``'s stderr."""
    out = {}
    for ln in log.splitlines():
        for stage in STAGES:
            tag = f"[{stage}]"
            if ln.strip().startswith(tag) and "s " in ln:
                try:
                    out[stage] = float(ln.split(tag)[1].split("s")[0])
                except ValueError:
                    pass
    return out


def count_rows(path: str) -> int:
    with open(path) as f:
        return sum(1 for line in f
                   if line.strip() and not line.startswith("#"))


class _Tee(io.TextIOBase):
    """stderr, kept (and passed on when ``echo``)."""

    def __init__(self, echo: bool):
        self.buf = io.StringIO()
        self.echo = echo

    def write(self, s):
        self.buf.write(s)
        if self.echo:
            sys.__stderr__.write(s)
        return len(s)

    def flush(self):
        sys.__stderr__.flush()


def run(fa: str, out_dir: str, aligner, jobs: int = 2,
        nbuckets: int = 1000, echo: bool = True) -> tuple[dict, dict]:
    """``run_pipeline`` over ``fa`` with every stage fresh (its stage lines
    passed on to stderr when ``echo``); returns (the report's run fields,
    the output paths)."""
    from ..config import DEFAULT
    from ..models.pipeline import run_pipeline
    from ..ops import wavefront as wf
    before = {w.__name__: w.launches for w in wf.KERNEL_WRAPPERS}
    tee = _Tee(echo)
    t0 = time.perf_counter()
    with redirect_stderr(tee):
        paths = run_pipeline(fa, out_dir, DEFAULT, nbuckets=nbuckets,
                             aligner=aligner, jobs=jobs, quiet=False,
                             force=True)
    wall = time.perf_counter() - t0
    base = getattr(aligner, "base", aligner)
    rows = {name: count_rows(p) for name, p in paths.items()}
    with open(fa + ".fai") as f:
        length = sum(int(line.split("\t")[1]) for line in f)
    return {
        "jobs": jobs,
        "nbuckets": nbuckets,
        "wall_s": wall,
        "stage_s": stage_walls(tee.buf.getvalue()),
        "rows": rows,
        "seeds_per_kbp": rows.get("seeds", 0) / (length / 1000),
        "device": str(base.device),
        "card": card_info() if base.device.type == "cuda" else None,
        "device_problems": base.device_problems,
        "device_cells": base.device_cells,
        "device_batches": base.device_batches,
        "launches": {w.__name__: w.launches - before[w.__name__]
                     for w in wf.KERNEL_WRAPPERS},
    }, paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--recipe", choices=RECIPES, default="dense")
    ap.add_argument("--mbp", type=float, default=3000.0,
                    help="genome size in Mbp (default 3000, hg19's)")
    ap.add_argument("--chroms", type=int, default=None,
                    help="chromosomes (default: the recipe's)")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--nbuckets", type=int, default=1000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--work", default=None,
                    help="directory of the genome and the outputs "
                         "(default: a temporary one, removed after)")
    ap.add_argument("--fresh", action="store_true",
                    help="regenerate a genome already in --work")
    args = ap.parse_args(argv)
    os.environ.setdefault("SEDEF_INDEX_CACHE_GB", "64")
    work = args.work or tempfile.mkdtemp(prefix="sedef_rehearsal_")
    try:
        al = make_aligner(args.device)
        t0 = time.perf_counter()
        fa, planted = generate(args.recipe, args.mbp, work, args.chroms,
                               args.fresh)
        made = time.perf_counter() - t0
        fields, _ = run(fa, os.path.join(work, "out"), al, args.jobs,
                        args.nbuckets)
        report = {"spec": spec_of(args.recipe, args.mbp, args.chroms),
                  "planted": planted, "genome_s": made, **fields}
        with open(os.path.join(work, "report.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps(report, indent=1), flush=True)
    finally:
        if args.work is None:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
