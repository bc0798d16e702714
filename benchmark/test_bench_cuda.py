"""On the card: a short run of every cell, plain and traced, is correct and
reports what the contract asks.  Skips without a card.

    python -m pytest -p no:cacheprovider benchmark/test_bench_cuda.py
"""

import json
import pathlib
import subprocess
import sys

import pytest

from harness import loader

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in loader.manifest()["workloads"]]


def _run(cell: str, trace: int) -> dict:
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", str(2**31 + 11), "--seconds", "8",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    out = _run(cell, 0)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    e2e, layer = loader.cell_metrics(loader.manifest(), cell)
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    traced = _run(cell, 1)
    assert traced["correct"] is True, traced["checks"]
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    assert set(traced["metrics"]) <= {m["name"] for m in layer}
    for name, m in traced["metrics"].items():
        if "roofline" in name:
            assert 0 < m["value"] <= 100
