"""Nothing the benchmark loads is JAX or the JAX package; the reference
imports nothing of the program; no result without a card."""

import os
import pathlib
import subprocess
import sys

from harness import guard

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def test_forbidden_names_compared_whole():
    mods = ["sedef_tpu_torch", "sedef_tpu_torch.ops.wavefront", "numpy",
            "jaxtyping", "reference.dp"]
    assert guard.forbidden_modules(mods) == []
    assert guard.forbidden_modules(mods + ["sedef_tpu.ops", "jax",
                                           "jaxlib.xla", "flax"]) == \
        ["flax", "jax", "jaxlib.xla", "sedef_tpu.ops"]


def test_static_scan_of_the_benchmark():
    for path in BENCH.rglob("*.py"):
        names = guard.imported_names(path)
        assert not names & guard.FORBIDDEN, (path, names & guard.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = guard.imported_names(path)
        assert "sedef_tpu_torch" not in names, path
        assert "torch" not in names, path
    for path in (BENCH / "reference").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert path.is_dir() or path.suffix == ".py", path  # Python alone
        if path.suffix == ".py":
            text = path.read_text()
            assert "import sedef_tpu" not in text
            assert "from sedef_tpu" not in text


def test_a_run_loads_no_jax():
    """The modules a CPU run of the harness loads (the program on its host
    route, the reference, the readers) hold no forbidden top-level name."""
    code = ("import sys; sys.argv=['x']; sys.path.insert(0, 'benchmark');"
            "import run; from harness import loader, guard;"
            "from sedef_tpu_torch.models import pipeline, simulate;"
            "from reference import cover, dp, rows;"
            "[loader.metric(m['name'])"
            " for m in loader.manifest()['per_layer']];"
            "print(guard.forbidden_modules(sys.modules))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "pairs-rand", "--seed", str(2**31 + 5), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: no
    result, neither from the command nor from a run past the card check."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "_cache",
                                                  "__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "pairs-rand", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run;"
            "print(run.run('pairs-rand', 1, 1.0, False, device='cpu'))")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "sedef_tpu_torch" in r.stderr
