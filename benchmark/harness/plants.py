"""What a run can put in the program's place, for the check to catch:
``run.py --plant <name>``.  The benchmark's own runs plant nothing.

* ``control``: the program with one guarantee the configurations state
  broken, the step that would tempt a later change: a gap DP whose two
  sides differ in length and whose longer side passes ``CONTROL_DP_GAP``
  bases is solved as a DP over the same-length prefixes plus one indel,
  an approximate gap DP (SEDEF takes that shortcut only past 1000 bases,
  which the program keeps);
* ``half_seeds``, ``half_regions``, ``half_pairs``: half of the work left
  out (every other seed row of a stage-1 job, before it is written and
  handed on; every other region of a stage-2b bin; every other pair's
  seeding);
* ``altered``: an answer altered where it is produced, by one (a genome's
  first row of each stage-2b bin, its start; the first row of each
  stage-3 call, its matchB column; a pair's first chain hit, its end).
"""

from __future__ import annotations

import contextlib

CONTROL_DP_GAP = 64

GENOME = ("control", "half_seeds", "half_regions", "altered")
PAIR = ("control", "half_pairs", "altered")


def _approximate(real):
    def align_batch(pairs):
        jobs, tails = [], []
        for q, t in pairs:
            mi, ma = min(len(q), len(t)), max(len(q), len(t))
            if mi and ma > CONTROL_DP_GAP and mi != ma:
                jobs.append((q[:mi], t[:mi]))
                tails.append(("D" if len(q) > mi else "I", ma - mi))
            else:
                jobs.append((q, t))
                tails.append(None)
        out = real(jobs)
        return [list(c) + ([tl] if tl else []) for c, tl in zip(out, tails)]
    return align_batch


@contextlib.contextmanager
def planted(name: str | None, driver):
    """Plant ``name`` for the duration of the block (nothing for None)."""
    if name is None:
        yield
        return
    allowed = GENOME if driver.unit == "genome" else PAIR
    if name not in allowed:
        raise SystemExit(f"no plant {name!r} for a {driver.unit} cell; "
                         f"one of {', '.join(allowed)}")
    undo = []

    def patch(owner, attr, new):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    if name == "control":
        patch(driver.aligner, "align_batch",
              _approximate(driver.aligner.align_batch))
    elif driver.unit == "genome":
        from sedef_tpu_torch.models import pipeline
        if name == "half_seeds":
            real_search = pipeline.search_stage

            def half(*a, sink, **k):
                return real_search(*a, sink=lambda job: sink(job[::2]), **k)
            patch(pipeline, "search_stage", half)
        elif name == "half_regions":
            real_bin = pipeline.OverlappedTail._submit_bin
            patch(pipeline.OverlappedTail, "_submit_bin",
                  lambda self, rows: real_bin(self, rows[::2]))
        else:
            from sedef_tpu_torch.models import reporter

            def altered(real, col):
                def produce(*a, **k):
                    rows = real(*a, **k)
                    if rows:
                        f = rows[0].split("\t")
                        f[col] = str(int(f[col]) + 1)
                        rows[0] = "\t".join(f)
                    return rows
                return produce
            patch(pipeline, "align_stage", altered(pipeline.align_stage, 1))
            patch(reporter, "stats_rows", altered(reporter.stats_rows, 16))
    else:
        if name == "half_pairs":
            real_seed = driver.seed_align
            calls = [0]

            def every_other(*a, **k):
                calls[0] += 1
                return real_seed(*a, **k) if calls[0] % 2 else []
            patch(driver, "seed_align", every_other)
        else:
            real_chain = driver.chain_align

            def altered(*a, **k):
                hits = real_chain(*a, **k)
                if hits:
                    hits[0].query_end -= 1
                return hits
            patch(driver, "chain_align", altered)
    try:
        yield
    finally:
        for owner, attr, old in reversed(undo):
            setattr(owner, attr, old)
