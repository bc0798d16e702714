"""Counterpart of ``tools/accuracy_table.py``.

Simulation accuracy table (the paper's ``output-rand.txt`` /
``output-chr1.txt`` analogues):

    python -m sedef_tpu_torch.tools.accuracy_table [runs_per_rate]
        [max_error] [max_len] [--jobs N] [--chr-analog]
        [--device cuda|cpu]

The reference harness's regime (``simulations.py:320-344``): SD pairs of
lengths uniform in [1000, max_len] (default 100,000, the reference's),
error rates 0..max_error in an order that interleaves low and high rates,
``runs_per_rate`` pairs a rate from ``random.Random(1000 + error)``, each
classified hit / miss / partial by ``models.simulate.classify_pair``; one
``error;hits;misses;partials`` line a rate.  Rates fan out over a process
pool of ``--jobs`` workers (default: the host's cores; started with
``spawn`` on ``cuda``).

``--chr-analog`` slices the pairs from a fixed repeat-realistic simulated
chromosome instead of fresh random sequence (hg19 chr1 is not available),
uppercase as the reference harness uppercases its sequences.

``--device cuda`` (the default) aligns on the card at the floors
``devcal`` measures (it raises without a card); ``--device cpu`` on the
host route (every gap DP on the native scalar DP).  The reference tool's
``--ref-oracle`` (the compiled reference binary's primitives) is not
ported.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

CLASSES = ("hit", "miss", "partial")


def chr_analog_sequence(length: int = 8_000_000) -> str:
    """A fixed repeat-realistic chromosome: random background + planted
    repeat families spanning the hg19-like divergence spectrum."""
    from ..models.genome_sim import simulate_genome
    chroms, _ = simulate_genome(length, 0, seed=101, n_chroms=1,
                                repeat_families=60, repeat_copies=50,
                                repeat_len=(300, 6000),
                                repeat_div=(0.02, 0.40))
    return "".join(chroms.values()).upper()


def classify_rate(error: int, runs: int, max_len: int,
                  chr_analog: bool = False, device: str = "cuda",
                  aligner=None) -> list[str]:
    """The class of each of ``runs`` pairs at ``error`` percent, in the
    order the rate's stream makes them."""
    from ..models.simulate import classify_pair, generate_random_sd
    from .rehearsal import make_aligner
    al = aligner if aligner is not None else make_aligner(device)
    seq = chr_analog_sequence() if chr_analog else None
    rng = random.Random(1000 + error)
    out = []
    for _ in range(runs):
        s1, s2, _ = generate_random_sd(rng, error, seq=seq, min_len=1000,
                                       max_len=max_len)
        out.append(classify_pair(s1, s2, error, aligner=al))
    return out


def one_rate(args):
    """(error, runs, max_len, chr_analog, device) -> (error, {class:
    count})."""
    error, runs, max_len, chr_analog, device = args
    import torch
    torch.set_num_threads(1)
    got = classify_rate(error, runs, max_len, chr_analog, device)
    return error, {c: got.count(c) for c in CLASSES}


def rate_order(max_err: int) -> list[int]:
    """0..max_err with low and high rates interleaved, so a partial long
    run still covers the whole divergence spectrum."""
    order = []
    lo, hi = 0, max_err
    while lo <= hi:
        order.append(lo)
        if hi != lo:
            order.append(hi)
        lo, hi = lo + 1, hi - 1
    return order


def row(error: int, out: dict) -> str:
    return f"{error};{out['hit']};{out['miss']};{out['partial']}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="?", type=int, default=20,
                    help="pairs a rate (default 20)")
    ap.add_argument("max_error", nargs="?", type=int, default=30)
    ap.add_argument("max_len", nargs="?", type=int, default=100_000)
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 2)
    ap.add_argument("--chr-analog", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    work = [(e, args.runs, args.max_len, args.chr_analog, args.device)
            for e in rate_order(args.max_error)]
    print("error;hits;misses;partials", flush=True)
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        ctx = multiprocessing.get_context(
            "spawn" if args.device == "cuda" else None)
        with ProcessPoolExecutor(max_workers=args.jobs,
                                 mp_context=ctx) as ex:
            for error, out in ex.map(one_rate, work):
                print(row(error, out), flush=True)
    else:
        for w in work:
            print(row(*one_rate(w)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
