"""Everything a cell needs, found by the names ``BENCHMARK.json`` gives."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def manifest(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def with_pending(bench: dict) -> dict:
    """``bench`` with the cells held back under ``pending/`` added: each
    file there holds one cell's entries as ``BENCHMARK.json`` would.  A
    held-back cell is out of the measured benchmark (``PERF.md`` says why);
    the benchmark's tests still run its code."""
    out = dict(bench)
    for path in sorted((BENCH_DIR / "pending").glob("*.json")):
        with open(path) as f:
            for section, entries in json.load(f).items():
                out[section] = out[section] + entries
    return out


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def driver(name: str):
    """The driver loop module ``drivers/<name>.py``."""
    return importlib.import_module(f"drivers.{name}")


def generator(name: str):
    """The traffic generator module ``generators/<name>.py``."""
    return importlib.import_module(f"generators.{name}")


def metric(name: str):
    """The per-layer metric's reader ``metrics/<name>.py`` (a metric's
    name may hold dots, so it is loaded from its path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metrics that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer
