"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import re

import pytest

from harness import loader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module", params=["measured", "with_pending"])
def bench(request):
    """BENCHMARK.json, and it with the held-back cells of ``pending/``
    added: each has to be ready to go back in."""
    b = loader.manifest()
    return loader.with_pending(b) if request.param == "with_pending" else b


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (loader.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(LINE.match(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_lines(bench):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section, e["name"]))
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [n for s, n in names if s == section]
        assert len(ns) == len(set(ns))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert LINE.match(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_moves_and_cells_agree(bench):
    cells = {w["name"] for w in bench["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            mv = e2e[m["moves"]]
            assert cell in mv.get("workloads", cells)
    for cell in cells:
        e, layer = loader.cell_metrics(bench, cell)
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2
        assert layer
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_every_file_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        cfg = loader.config(c["name"])
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert loader.driver(cfg["driver"]).Driver
        assert set(cfg["checks"]) and all(v >= 0
                                          for v in cfg["checks"].values())
        assert set(cfg["scores"]) == {"match", "mismatch", "gap_open",
                                      "gap_ext"}
    for w in bench["workloads"]:
        t = loader.traffic(w["traffic"])
        assert hasattr(loader.generator(t["generator"]), "make")
    for m in bench["per_layer"]:
        mod = loader.metric(m["name"])
        assert mod.SOURCE == m["source"]
        assert callable(mod.read)


def test_layers_are_perf_md_layers(bench):
    """Each per-layer metric's layer is named in PERF.md's list of layers."""
    text = (loader.ROOT / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert m["layer"] in text, m["layer"]


def test_check_budget_fits_the_full_benchmark(bench):
    """2 + 14 x 24 runs of run_seconds + 60, 2 x 90 s a cell to compile,
    1,200 spare: within 43,200 s."""
    cells = 24
    total = ((2 + 14 * cells) * (bench["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200


def test_readers_return_nothing_on_an_empty_context(bench):
    ctx = {"unit": "genome", "n": 0, "spans": {}, "trace": None,
           "gapdp": [], "peak": None}
    for m in bench["per_layer"]:
        assert loader.metric(m["name"]).read(ctx) is None


def test_manifest_is_plain_json():
    text = (loader.ROOT / "BENCHMARK.json").read_text()
    assert json.loads(text)


def test_pending_cells_join_the_metrics_of_their_unit():
    """A held-back cell joins the ``workloads`` of the measured metrics of
    its unit (a genome cell the genome metrics), no other, and the
    measured manifest is left as it was."""
    b = loader.manifest()
    before = json.dumps(b)
    merged = loader.with_pending(b)
    assert json.dumps(b) == before
    held = {w["name"] for w in merged["workloads"]} - \
        {w["name"] for w in b["workloads"]}
    for m in merged["end_to_end"] + merged["per_layer"]:
        if "workloads" not in m:
            continue
        units = {loader.unit(merged, c) for c in m["workloads"]}
        assert len(units) == 1
        for cell in held:
            assert (cell in m["workloads"]) == \
                (loader.unit(merged, cell) in units)
