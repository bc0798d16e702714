"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell, its configuration, its traffic, its
driver loop, its generator and its per-layer metrics are all found by the
names in ``BENCHMARK.json``.  The run makes its inputs from the seed, builds
the program's aligner and warms it up (all of that is ``setup_s``), drives
the program for the window, reads the card's memory peak, frees the program,
then has the plain reference judge a sample of the window's answers.
``--trace 1`` runs the same window under torch.profiler's CUDA activity,
with the benchmark's spans around the program's entry calls and the
program's own spans and counters on (``sedef_tpu_torch/trace.py``, reset
at the window's start), and reports the per-layer metrics instead of the
end-to-end ones; an untraced run leaves the program's trace off.
``--plant <name>`` puts the control or a fault in the program's place, for
the readings the check's limits are set from; a measured run never takes
it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every kernel or build cache at a fixed path inside the checkout
CACHE = BENCH_DIR / "_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import guard, loader  # noqa: E402


def _passes(c: dict) -> bool:
    return c["value"] <= c["limit"] if c["op"] == "<=" else \
        c["value"] >= c["limit"]


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", traffic: dict | None = None,
        plant: str | None = None) -> dict:
    """One run; returns the result's object.  ``device`` "cpu" and a
    ``traffic`` of its own are for the benchmark's CPU tests only;
    ``plant`` puts the control or a fault in the program's place
    (``harness/plants.py``)."""
    from harness import plants
    import torch

    bench = loader.manifest()
    cell = loader.workload(bench, workload)
    config = loader.config(cell["config"])
    traffic = traffic or loader.traffic(cell["traffic"])
    e2e, layer = loader.cell_metrics(bench, workload)
    on_card = device == "cuda"
    workdir = tempfile.mkdtemp(prefix="sedef-bench-")
    try:
        drv = loader.driver(config["driver"]).Driver(
            config, traffic, seed, workdir, device)
        drv.setup()
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T0

        spans = dev_trace = shapes = snap = None
        stack = plants.planted(plant, drv)
        stack.__enter__()
        drv.record()
        if trace:
            from harness.spans import Spans
            from harness.trace import DeviceTrace, GapDPRecord
            from sedef_tpu_torch.ops import wavefront
            spans = Spans()
            for owner, attr, name in drv.spans():
                spans.install(owner, attr, name)
            shapes = GapDPRecord(wavefront)
            shapes.install()
            from sedef_tpu_torch import trace as program_trace
            dev_trace = DeviceTrace(torch)
            dev_trace.__enter__()
            # zeroes every registered counter too: they count the window
            program_trace.reset()
            program_trace.enable()
        try:
            res = drv.window(seconds)
        finally:
            if trace:
                program_trace.disable()
                dev_trace.__exit__(None, None, None)
                spans.restore()
                shapes.restore()
                snap = program_trace.snapshot()
                print(f"program trace: {len(snap['spans'])} spans kept, "
                      f"{snap['counters']['trace']['dropped']} dropped",
                      file=sys.stderr)
            stack.__exit__(None, None, None)
        if on_card:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        found = guard.forbidden_modules(sys.modules)
        if found:
            raise SystemExit("forbidden modules loaded by the window: "
                             + ", ".join(found))
        gap_lengths = shapes.lengths() if trace else []
        drv.release()
        if on_card:
            torch.cuda.empty_cache()
        checks = drv.check()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    metrics = {}
    if not trace:
        values = dict(res["metrics"], setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        from roofline.peaks import peak as peak_of
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
        ctx = {"unit": drv.unit, "n": res["n"], "spans": spans.seconds(),
               "trace": dev_trace, "gapdp": gap_lengths,
               "peak": peak_of(kind), "program": snap}
        for m in layer:
            v = loader.metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {
        "correct": res["failed"] == 0 and all(map(_passes, checks)),
        "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        out["device"]["busy_s"] = dev_trace.busy_s
        out["device"]["window_s"] = dev_trace.window_s
        out["breakdown"] = {"device_ops": dev_trace.device_ops(),
                            "idle_gaps": dev_trace.idle_gaps(
                                spans, program=snap)}
    out["checks"] = {c["name"]: {"value": c["value"], "op": c["op"],
                                 "limit": c["limit"]} for c in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--plant", default=None,
                    help="the control or a fault in the program's place, "
                    "for the check's own readings (harness/plants.py); "
                    "never in a measured run")
    args = ap.parse_args(argv)

    import torch
    chips = int(loader.workload(loader.manifest(), args.workload)["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"this cell needs {chips} CUDA device(s); found {found} (no "
              "result: the benchmark never measures on the CPU)",
              file=sys.stderr)
        return 3
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              plant=args.plant)
    found = guard.forbidden_modules(sys.modules)
    if found:
        print("forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4
    import resource
    print(f"host peak RSS: "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024} MB",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} {c['op']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
