"""The port's fill-variant harness (``sedef_tpu_torch.tools.kbench``,
``wavefront_fill_variant``) against the reference package: its NumPy
reference on the harness's own golden problem, and its experiment kernel
(``tools/kbench.make_kernel``) run in interpret mode.  On the CPU every
variant runs the plain fill, which is what each CUDA variant is held to on
the card.  Tolerance: exact equality (integer DP, direction bytes and
CIGARs)."""

import functools
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sedef_tpu.ops import wavefront as ref_wf
from sedef_tpu_torch.ops import wavefront as wf
from sedef_tpu_torch.tools import kbench

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref_kbench():
    """The reference harness, loaded from its file (``tools`` is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        "ref_kbench", os.path.join(REPO, "tools", "kbench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", wf.FILL_VARIANTS)
def test_variant_on_golden_problem(variant):
    """The reference harness's own check, and the band bytes."""
    qseq, tgt, qs, ts = kbench.golden_problem()
    q, t = torch.from_numpy(qseq), torch.from_numpy(tgt)
    before = wf.wavefront_fill_variant.launches
    p = wf.wavefront_fill_variant(variant, q, t)
    assert wf.wavefront_fill_variant.launches == before
    assert p.shape == (8, 255, 128) and p.dtype == torch.uint8
    torch.testing.assert_close(p, wf.wavefront_fill_torch(q, t), rtol=0,
                               atol=0)
    for i, (qi, ti) in enumerate(zip(qs, ts)):
        p_ref, _ = ref_wf.wavefront_np(qi, ti)
        assert (wf.backtrack_np(p[i].numpy(), len(qi), len(ti))
                == ref_wf.backtrack_np(p_ref, len(qi), len(ti))), i
    assert kbench.check_correct(variant, "cpu")


def test_golden_problem_is_the_reference_harnesses():
    """Same generator, same order of draws as ``check_correct`` there."""
    qseq, tgt, qs, ts = kbench.golden_problem()
    rng = np.random.default_rng(3)
    qlens = rng.integers(60, 128, 8)
    tlens = rng.integers(60, 128, 8)
    for i in range(8):
        q = rng.integers(0, 4, qlens[i]).astype(np.int8)
        t = rng.integers(0, 4, tlens[i]).astype(np.int8)
        np.testing.assert_array_equal(qs[i], q)
        np.testing.assert_array_equal(ts[i], t)
        np.testing.assert_array_equal(qseq[i, :qlens[i]], q)
        assert (qseq[i, qlens[i]:] == 4).all() and (tgt[i, tlens[i]:]
                                                    == 4).all()


@pytest.mark.parametrize("ref_variant,variant", [("base", "base"),
                                                 ("pack", "pack")])
def test_band_bytes_match_reference_kernel_interpreted(
        ref_kbench, monkeypatch, ref_variant, variant):
    """``tools/kbench.make_kernel`` in interpret mode (its file untouched:
    ``pallas_call`` is wrapped for the length of the test) writes the
    port's direction bytes on every band lane."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    S = 128
    qseq, tgt, _, _ = kbench.golden_problem(S)
    qc = np.full((8, ref_kbench._padded_rows(S, S)), 4, np.int32)
    qc[:, :S] = qseq
    run = ref_kbench.make_kernel(ref_variant, S, S)
    p = np.asarray(run(jnp.asarray(qc), jnp.asarray(tgt)))
    # (B/8, rows, 8, S_t) -> (B, S_q + S_t - 1, S_t)
    ref = torch.from_numpy(np.ascontiguousarray(
        p[0].transpose(1, 0, 2)[:, :2 * S - 1]))
    got = wf.wavefront_fill_variant(variant, torch.from_numpy(qseq),
                                    torch.from_numpy(tgt))
    assert kbench.band_mismatches(got, ref, S, S) == 0


def test_packed_state_round_trips_and_matches_the_layout():
    """x in bits 0-7, v + 128 in bits 8-15, the query code in bits 16-19
    (``tools/kbench.py``'s packed layout), over the full value ranges."""
    x, v, q = torch.meshgrid(torch.arange(0, 256), torch.arange(-128, 128),
                             torch.arange(0, 5), indexing="ij")
    word = wf.pack_state_torch(x, v, q)
    assert word.dtype == torch.int32
    assert torch.equal(word, (q << 16 | (v + 128) << 8 | x).to(torch.int32))
    assert torch.equal(word & 0xFF, x.to(torch.int32))
    assert torch.equal((word >> 8) & 0xFF, (v + 128).to(torch.int32))
    assert torch.equal((word >> 16) & 0xF, q.to(torch.int32))
    assert int(word.max()) < 1 << 20 and int(word.min()) >= 0
    xs, vs, qs = wf.unpack_state_torch(word)
    for got, want in ((xs, x), (vs, v), (qs, q)):
        assert torch.equal(got, want.to(torch.int32))
    # the reference's initial word: x = 0, v = 0, wildcard code
    assert int(wf.pack_state_torch(*map(torch.tensor, (0, 0, 4)))) == (
        (4 << 16) | (128 << 8))


def test_state_of_the_default_scoring_fits_the_packed_word():
    """Every x and v the fill carries in the band lies in the ranges the
    packed word holds (checked on the golden problem's own state)."""
    qseq, tgt, _, _ = kbench.golden_problem()
    q, t = torch.from_numpy(qseq), torch.from_numpy(tgt)
    S = 128
    ckpt = wf.tile_checkpoint_torch(q, t, 4)  # state entering every 4th row
    for ti in range(1, ckpt.shape[1]):
        band = wf.stream_band(ti * 4 - 1, ti * 4, S, S)[0]
        u, y, x, v = (ckpt[:, ti, c][:, band] for c in range(4))
        assert 0 <= int(x.min()) and int(x.max()) <= 40
        assert 0 <= int(v.min()) and int(v.max()) <= 87
        assert 0 <= int(u.min()) and int(u.max()) <= 87


@pytest.mark.parametrize("bad", ["name", "S_t", "wide", "scores"])
def test_variant_wrapper_rejects(bad):
    q = torch.zeros((2, 128), dtype=torch.int8)
    t = torch.zeros((2, 128), dtype=torch.int8)
    variant, kw = "reg", {}
    if bad == "name":
        variant = "reg3"
    elif bad == "S_t":
        t = torch.zeros((2, 130), dtype=torch.int8)
    elif bad == "wide":
        t = torch.zeros((2, 4100), dtype=torch.int8)
    else:
        variant, kw = "preg", {"gapo": 80}
    with pytest.raises(ValueError):
        wf.wavefront_fill_variant(variant, q, t, **kw)
    if bad in ("S_t", "wide"):  # base takes any class that fits
        assert wf.wavefront_fill_variant("base", q, t).shape[2] == t.shape[1]


def test_variant_joins_the_kernel_wrappers():
    assert wf.wavefront_fill_variant in wf.KERNEL_WRAPPERS
    assert len(wf.KERNEL_WRAPPERS) == 10
    assert isinstance(wf.wavefront_fill_variant.launches, int)


def test_kbench_cpu_runs_without_jax(tmp_path):
    """``python -m sedef_tpu_torch.tools.kbench --device cpu`` checks every
    variant, prints no times, and imports neither jax nor sedef_tpu."""
    code = ("import runpy, sys\n"
            "sys.argv = ['kbench', '--device', 'cpu']\n"
            "try:\n"
            "    runpy.run_module('sedef_tpu_torch.tools.kbench', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "assert 'jax' not in sys.modules\n"
            "assert not any(m == 'sedef_tpu' or m.startswith('sedef_tpu.')"
            " for m in sys.modules)\n"
            "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[-1] == "NO_JAX_OK"
    assert [ln.split()[0] for ln in lines[:-1]] == list(wf.FILL_VARIANTS)
    assert all(ln.split()[1] == "correct=True" for ln in lines[:-1])
    assert " ms" not in r.stdout and "GCUPS" not in r.stdout


def test_kbench_cuda_without_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        kbench.main(["--device", "cuda", "base"])
    assert e.value.code not in (0, None)


def test_tiled_plans_grid():
    """The tiled table's grid: a plan per (C, N), None where C blocks of
    4096 lanes cannot hold the class."""
    plans = kbench.tiled_plans(10240, 4, 132)
    assert set(plans) == {(C, N) for C in kbench.TILED_CLUSTERS
                          for N in kbench.TILED_ROWS_PER_BARRIER}
    assert plans[1, 8] is None and plans[2, 32] is None
    assert plans[4, 8] == wf.TilePlan(4, 2560, 4, 8, 32)
    assert plans[16, 1] == wf.TilePlan(16, 640, 2, 1, 4)
    assert all(p is None for (C, _), p in
               kbench.tiled_plans(61440, 1, 132).items() if C < 16)
    assert all(p is not None for p in
               kbench.tiled_plans(4096, 4, 132).values())


def test_bench_tiled_cpu_path():
    """``bench_tiled`` on the CPU with a counting timer: every feasible
    plan goes through the wrappers (the plain versions here), the table has
    a checkpoint and a refill cell per plan, and no kernel is launched."""
    calls = []

    def timer(fn, n, warm):
        fn()
        calls.append(n)
        return float(len(calls))

    lines = []
    n0 = (wf.tile_checkpoint.launches, wf.tile_refill.launches)
    table = kbench.bench_tiled("cpu", shapes=((96, 64, 2, 1), (64, 32, 4, 2)),
                               log=lines.append, timer=timer)
    assert set(table) == {(96, 64, 2, 1), (64, 32, 4, 2)}
    row = table[96, 64, 2, 1]
    feasible = [k for k, p in kbench.tiled_plans(64, 2, 132).items() if p]
    assert len(feasible) == 15
    for key in table:
        for C, N in feasible:
            assert table[key]["ckpt", C, N] > 0
            assert table[key]["refill", C, N] > 0
    assert row["plan"] == wf.tile_plan(64, 2, 132)
    assert all(row[what, "lanes", n] > 0 for what in ("ckpt", "refill")
               for n in wf.TILE_LANES)
    assert len(calls) == 2 * (2 + 2 * len(feasible) + 6)
    assert (wf.tile_checkpoint.launches, wf.tile_refill.launches) == n0
    assert lines[0].startswith("tiled (96,64) B=2 K=1 tile=1024")
    assert lines[8].startswith("checkpoint at C=1 N=32 over lanes a thread: "
                               "1 lanes ")
    assert lines[10].startswith("tiled (64,32) B=4 K=2 tile=1024")
    assert lines[1].split() == [f"C={C}" for C in kbench.TILED_CLUSTERS]
    assert [ln.split()[0] for ln in lines[2:8]] == ["checkpoint"] * 3 + [
        "refill"] * 3


def test_fill_plans_grid():
    """The direct-fill table's columns: every organisation the plan can be
    forced into at a shape, and none it cannot."""
    narrow = kbench.fill_plans(128, 128, 32, 132)
    assert list(narrow) == ["warp x4", "warp x8", "owned", "owned N=2",
                            "C=1 l1",
                            "C=1 l2", "C=1 l4", "C=2", "C=4", "C=8", "C=16"]
    assert (narrow["owned"].N, narrow["owned N=2"].N) == (4, 2)
    assert narrow["warp x8"].per_block == 8 and narrow["C=4"].W == 32
    wide = kbench.fill_plans(8192, 8192, 2, 132)
    assert list(wide) == ["C=2", "C=4", "C=8", "C=16"]
    assert wide["C=2"] == wf.FillPlan("cluster", 2, 4096, 4, 32, 128, 1)
    mid = kbench.fill_plans(1024, 1024, 64, 132)
    assert "warp x4" not in mid and mid["owned"].org == "owned"
    assert [mid[f"C=1 l{n}"].lanes for n in (1, 2, 4)] == [1, 2, 4]
    assert "owned" not in kbench.fill_plans(256, 1030, 4, 132)
    assert set(kbench.FILL_SHAPES) >= {(128, 128, 32), (128, 128, 256),
                                       (128, 128, 4096), (1024, 1024, 64),
                                       (1024, 1024, 1056), (2048, 2048, 32),
                                       (4096, 4096, 4), (8192, 8192, 2)}


def test_bench_fill_cpu_path():
    """``bench_fill`` on the CPU with a counting timer: every forced plan
    goes through ``wavefront_fill`` (the plain fill here), is held against
    ``base``, and no kernel is launched."""
    calls = []

    def timer(fn, n, warm):
        fn()
        calls.append(n)
        return float(len(calls))

    lines = []
    n0 = (wf.wavefront_fill.launches, wf.wavefront_fill_variant.launches)
    table = kbench.bench_fill("cpu", shapes=((40, 36, 3), (24, 136, 2)),
                              log=lines.append, timer=timer)
    assert set(table) == {(40, 36, 3), (24, 136, 2)}
    for (S_q, S_t, B), row in table.items():
        plans = kbench.fill_plans(S_q, S_t, B, 132)
        assert row["plan"] == wf.fill_plan(S_q, S_t, B, 132)
        assert all(row[k] > 0 for k in ("base", "own", *plans))
    assert table[40, 36, 3]["plan"].org == "warp"
    assert table[24, 136, 2]["plan"].org == "owned"
    assert len(calls) == sum(2 + len(kbench.fill_plans(*k, 132))
                             for k in table)
    assert (wf.wavefront_fill.launches,
            wf.wavefront_fill_variant.launches) == n0
    assert lines[0].startswith("fill (40,36) B=3: base ")
    assert "own plan warp C=1 W=128 lanes=4 per_block=4" in lines[0]
    assert "warp x4 " in lines[0] and "warp x8 " in lines[0]


def test_bench_streamed_cpu_path():
    """``bench_streamed`` on the CPU with a counting timer: the direct fill
    and, for every K dividing the batch, the streamed fill under both
    organisations (the plain fill here, held chain against parallel), with
    the bytes of each matrix; no kernel is launched."""
    calls = []

    def timer(fn, n, warm):
        fn()
        calls.append(n)
        return float(len(calls))

    lines = []
    n0 = (wf.wavefront_fill.launches, wf.wavefront_fill_streamed.launches)
    table = kbench.bench_streamed("cpu", shapes=((40, 36, 6), (24, 132, 4)),
                                  ks=(2, 3, 4), log=lines.append,
                                  timer=timer)
    assert set(table[40, 36, 6]) == {"direct", "direct_bytes", 2, 3}
    assert set(table[24, 132, 4]) == {"direct", "direct_bytes", 2, 4}
    cell = table[40, 36, 6][3]
    assert cell["bytes"] == 2 * (3 * 40 + 36 - 1) * 36
    assert table[40, 36, 6]["direct_bytes"] == 6 * (40 + 36 - 1) * 36
    assert cell["plans"]["parallel"] == wf.stream_plan(40, 36, 2, 3, 132)
    assert cell["plans"]["chain"].org == "chain"
    assert cell["parallel"] > 0 and cell["chain"] > 0
    assert wf.stream_plan(40, 36, 2, 3, 132).org == "parallel"
    assert len(calls) == 2 + 2 * 4
    assert (wf.wavefront_fill.launches,
            wf.wavefront_fill_streamed.launches) == n0
    assert lines[1].startswith("streamed (40,36) B=6: direct ")
    assert "K=3: parallel (owned C=1) " in lines[1]
    assert f"chain (C=1) 5.000, p {cell['bytes']}" in lines[1]
    assert {(1024, 1024, 64), (1024, 1024, 264), (1024, 1024, 1056),
            (2048, 2048, 50), (2048, 2048, 528),
            (8192, 8192, 34)} <= set(kbench.STREAM_SHAPES)


def test_walk_plans_grid():
    plans = kbench.walk_plans(4, 132)
    assert list(plans) == ["thread", "R=32", "R=32 prefetch", "R=64",
                           "R=64 prefetch"]
    assert plans["thread"].R == 0
    assert plans["R=32"] == wf.WalkPlan(32, 48, False, 1)
    assert plans["R=64 prefetch"] == wf.WalkPlan(64, 144, True, 1)
    assert kbench.walk_plans(1000, 132)["R=64"].warps == wf.WALK_WARPS
    assert set(kbench.WALK_SHAPES) == {(1024, 1024, 64), (10240, 10240, 4),
                                       (61440, 61440, 1)}


def test_bench_walk_cpu_path():
    """``bench_walk`` on the CPU with a counting timer: every walk plan
    walks every tile through ``tile_backtrack`` (the plain walk here), the
    plans agree, and no kernel is launched."""
    calls = []

    def timer(fn):
        fn()
        calls.append(1)
        return 0.5

    lines = []
    n0 = wf.tile_backtrack.launches
    table = kbench.bench_walk("cpu", shapes=((48, 40, 2),),
                              log=lines.append, timer=timer)
    row = table[48, 40, 2]
    assert row["tiles"] == 1 and 40 <= row["rows"] <= 2 * 87
    assert all(row[k] == 0.5 for k in kbench.walk_plans(2, 132))
    assert len(calls) == 5
    assert wf.tile_backtrack.launches == n0
    assert lines[0].startswith("walk (48,40) B=2 tile=1024 x1, ")


def test_related_codes_share_their_diagonal():
    q, t = kbench.related_codes(3, 64, 80, "cpu", seed=1)
    assert q.shape == (3, 64) and t.shape == (3, 80)
    assert q.dtype == t.dtype == torch.int8
    same = (q == t[:, :64]).float().mean()
    assert 0.85 < float(same) < 0.99


SASS_SAMPLE = """
Fatbin elf code:
================
arch = sm_90a
\t\tFunction : sedef_probe_owned
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   IADD3 R2, R0, 0x1, RZ ;
        /*0030*/                   NOP ;
        /*0040*/                   LOP3.LUT R3, R2, R0, RZ, 0x3c, !PT ;
        /*0050*/               @P0 BRA 0x20 ;
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x70;
\t\tFunction : sedef_probe_owned2
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   VIADD.16x2 R7, R0, R7 ;
        /*0020*/              @!P1 BRA 0x10 ;
        /*0030*/                   EXIT ;

Fatbin elf code:
================
\t\tFunction : other_unit_kernel
        /*0000*/                   BRA 0x0 ;
"""


def test_sass_loop_count_reads_the_widest_backward_branch():
    """``sass_counts``' parser: functions of the section holding the
    probes, the instructions (NOPs left out) from a backward branch's
    target to the branch, the widest such loop."""
    funcs = kbench._sass_functions(SASS_SAMPLE)
    assert sorted(funcs) == ["sedef_probe_owned", "sedef_probe_owned2"]
    assert kbench._loop_instructions(funcs["sedef_probe_owned"]) == 3
    assert kbench._loop_instructions(funcs["sedef_probe_owned2"]) == 2
    assert kbench._loop_instructions([(0, "EXIT")]) == 0


def test_sass_probes_cover_the_redesigned_variants():
    probed = {v for vs in kbench.SASS_PROBES.values() for v in vs}
    for v in ("unroll4", "reg4", "dpx2", "dpx2u4", "dpx2reg", "clu2", "clu4",
              "dpx2clu2", "dpx2clu4"):
        assert v in probed and v in kbench.SASS_KERNELS
    assert probed <= set(wf.FILL_VARIANTS)


def test_sass_counts_without_a_toolkit_is_empty(monkeypatch):
    from sedef_tpu_torch.native import build

    def missing():
        raise FileNotFoundError("nvcc")
    monkeypatch.setattr(build, "nvcc_path", missing)
    monkeypatch.setattr("shutil.which", lambda name: None)
    assert kbench.sass_counts() == {}


def test_variant_shapes_are_the_harness_and_the_main_paths():
    assert kbench.VARIANT_SHAPES == ((1024, 1024, 64), (1024, 1024, 1056),
                                     (128, 128, 32), (1024, 1024, 4),
                                     (2048, 2048, 2))
    for shape in kbench.VARIANT_SHAPES:
        assert all(kbench.variant_takes(v, shape[1])
                   for v in wf.FILL_VARIANTS)
    assert not kbench.variant_takes("clu4", 144)
    assert kbench.variant_takes("base", 130)


def test_bench_rows_cpu_path():
    """``bench_rows`` on the CPU with a counting timer: a row's time is
    the launch's over its rows, and each variant appears only at the widths
    it takes; no kernel is launched."""
    calls = []

    def timer(fn, n, warm):
        fn()
        calls.append(n)
        return 1.0

    lines = []
    n0 = wf.wavefront_fill_variant.launches
    table = kbench.bench_rows("cpu", widths=(32, 48), S_q=20,
                              variants=("dpx2", "clu4", "dpx2clu2"),
                              log=lines.append, timer=timer)
    assert set(table) == {32, 48}
    assert table[32] == {k: 1e3 / 51 for k in ("wavefront_fill", "dpx2",
                                               "clu4", "dpx2clu2")}
    assert set(table[48]) == {"wavefront_fill", "dpx2", "dpx2clu2"}
    assert len(calls) == 7
    assert wf.wavefront_fill_variant.launches == n0
    assert lines[0].startswith("rows (20,32) B=1: us a row wavefront_fill ")
    assert "rows" in kbench.TABLES
