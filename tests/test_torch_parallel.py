"""The port's multi-device and multi-process modules (``parallel/mesh.py``,
``parallel/distributed.py``) against the reference package on the same
inputs, on the CPU: gloo process groups of 2 and 4 ranks on localhost, and
``MeshAligner`` over CPU devices.  Tolerance: exact equality (q-gram
scores, direction bytes on the band, counters, CIGARs, BED bytes).

Every test that starts processes gives each a time limit, and each
process group a timeout, so that a stuck rank fails the test."""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sedef_tpu.models.pipeline import run_pipeline as ref_run_pipeline
from sedef_tpu.ops.wavefront import WavefrontAligner as RefAligner
from sedef_tpu.parallel import mesh as ref_mesh
from sedef_tpu_torch.models.pipeline import run_pipeline
from sedef_tpu_torch.ops import filter as filt
from sedef_tpu_torch.ops import wavefront as wf
from sedef_tpu_torch.parallel import mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 300
GROUP_TIMEOUT_S = 240

# prepended to every worker: the repo on the path, one thread, and at the
# end a check that neither jax nor the reference package was imported
_PRELUDE = f"""
import sys
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(1)
"""
_NO_REFERENCE = """
assert 'jax' not in sys.modules
assert not any(m == 'sedef_tpu' or m.startswith('sedef_tpu.')
               for m in sys.modules)
"""


def _fresh_port() -> str:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return str(sock.getsockname()[1])


def _run_ranks(cmds, attempts=3, env=None):
    """Start one process per command (``{port}`` filled with a fresh port)
    and wait for all; on a failure (the free-port race, a slow rendezvous
    under load) retry on a fresh port.  Returns the outputs."""
    outs = []
    for _ in range(attempts):
        port = _fresh_port()
        procs = [subprocess.Popen([a.format(port=port) for a in cmd],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, env=env)
                 for cmd in cmds]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=PROC_TIMEOUT_S)[0]
                            .decode()[-3000:])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if all(p.returncode == 0 for p in procs):
            return outs
    raise AssertionError("ranks failed on every attempt:\n"
                         + "\n---\n".join(outs))


def _worker(tmp_path, body: str) -> str:
    path = tmp_path / "worker.py"
    path.write_text(_PRELUDE + textwrap.dedent(body) + _NO_REFERENCE)
    return str(path)


def test_mesh_shape():
    """The reference's squarest (pairs, data) factorization and axes."""
    for n in range(1, 9):
        rm = ref_mesh.make_mesh(n)
        assert mesh.mesh_shape(n) == tuple(rm.devices.shape)
        assert mesh.AXES == rm.axis_names
    assert mesh.mesh_shape(12) == (3, 4) and mesh.mesh_shape(7) == (1, 7)


@pytest.mark.parametrize("W", [5, 64, 100])
def test_qgram_scores_match_host(W):
    """Equal to the host histogram intersection (ops/filter) and to the
    reference's qgram_scores, over leading batch dims, int32 throughout;
    codes above 3 drop their grams as the reference's scatter does."""
    rng = np.random.default_rng(W)
    a = rng.integers(0, 4, (2, 3, W)).astype(np.uint8)
    b = rng.integers(0, 4, (2, 3, W)).astype(np.uint8)
    got = mesh.qgram_scores(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (2, 3)
    for i in range(2):
        for j in range(3):
            ha = filt._qgram_hist(a[i, j])
            hb = filt._qgram_hist(b[i, j])
            assert got[i, j] == int(np.minimum(ha, hb).sum())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_mesh.qgram_scores(a, b)))
    a[0, 0, ::7] = 4
    b[1, 2, ::5] = 9
    np.testing.assert_array_equal(
        mesh.qgram_scores(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref_mesh.qgram_scores(a, b)))


@pytest.mark.parametrize("top,shape", [(5, (4, 5)), (5, (2, 3, 64)),
                                       (256, (3, 128)), (256, (7, 5))])
def test_qgram_scores_wrapper_on_cpu_is_plain_and_reference(top, shape):
    """On CPU tensors ``qgram_scores`` is its plain version and equals the
    reference's, values and dtypes: codes 0-4 and 0-255 (grams past the
    bins dropped), one gram (W = 5), leading dims; no kernel launched."""
    rng = np.random.default_rng(top + shape[-1])
    a = rng.integers(0, top, shape).astype(np.uint8)
    b = a.copy()
    flip = rng.random(shape) < 0.3
    b[flip] = rng.integers(0, top, int(flip.sum()))
    before = mesh.qgram_scores.launches
    T = torch.from_numpy
    got = mesh.qgram_scores(T(a), T(b))
    assert torch.equal(got, mesh.qgram_scores_torch(T(a), T(b)))
    want = np.asarray(ref_mesh.qgram_scores(a, b))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert mesh.qgram_scores.launches == before


def test_qgram_scores_wrapper_refuses_other_devices():
    m = torch.zeros((2, 16), dtype=torch.uint8, device="meta")
    c = torch.zeros((2, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        mesh.qgram_scores(m, m)
    with pytest.raises(ValueError):
        mesh.qgram_scores(c, m)


def qgram_model(a, b):
    """``csrc/qgram.cu`` pair by pair: a's grams (uint32 shift-or) counted
    into 1,024 bins, then each of b's grams, in the block's thread order,
    takes one from its bin and counts a match where the bin held more than
    0; grams of 1,024 and above are dropped."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).astype(np.uint32)
    b2 = b.reshape(-1, b.shape[-1]).astype(np.uint32)
    n = a2.shape[1] - filt.QG + 1
    out = np.zeros(a2.shape[0], np.int32)
    for r in range(a2.shape[0]):
        ga = np.zeros(max(n, 0), np.uint32)
        gb = np.zeros(max(n, 0), np.uint32)
        for j in range(filt.QG):
            ga = (ga << np.uint32(2)) | a2[r, j:j + n]
            gb = (gb << np.uint32(2)) | b2[r, j:j + n]
        hist = np.zeros(filt.QSZ, np.int64)
        np.add.at(hist, ga[ga < filt.QSZ], 1)
        order = np.argsort(np.arange(n) % 128, kind="stable")
        for g in gb[order]:
            if g < filt.QSZ:
                out[r] += hist[g] > 0
                hist[g] -= 1
    return out.reshape(lead)


@pytest.mark.parametrize("top,W", [(4, 128), (5, 64), (256, 40), (4, 5)])
def test_qgram_model_matches_plain(top, W):
    """The kernel's decrement count against the plain version's minimum
    of two histograms."""
    rng = np.random.default_rng(W)
    a = rng.integers(0, 4, (6, W)).astype(np.uint8)
    plant = rng.random(a.shape) < 0.2
    a[plant] = rng.integers(0, top, int(plant.sum()))
    b = a.copy()
    flip = rng.random(a.shape) < 0.1
    b[flip] = rng.integers(0, 4, int(flip.sum()))
    want = mesh.qgram_scores_torch(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(qgram_model(a, b), want.numpy())
    assert (want.numpy() > 0).any()


def test_multichip_step_runs(tmp_path):
    """4 gloo ranks in a 2x2 mesh, each running the step on its shard:
    equal to the reference's build_multichip_step on its CPU mesh of the
    same shape and inputs (direction bytes and mcells on each problem's
    band, qg, total, total_passed, counts)."""
    pp, dd = mesh.mesh_shape(4)
    inputs = mesh.example_inputs(pp, dd, B=3)
    np.savez(tmp_path / "in.npz", *inputs)
    worker = _worker(tmp_path, f"""
        import numpy as np
        from sedef_tpu_torch.parallel.distributed import init_distributed
        from sedef_tpu_torch.parallel.mesh import make_mesh, multichip_step
        rank = int(sys.argv[1])
        init_distributed("localhost:" + sys.argv[2], 4, rank,
                         timeout_s={GROUP_TIMEOUT_S})
        m = make_mesh(4, "cpu")
        pp, dd = m.mesh.shape
        i, j = divmod(rank, dd)
        d = np.load({str(tmp_path / "in.npz")!r})
        shard = [torch.from_numpy(d[f"arr_{{k}}"][i, j]) for k in range(4)]
        out = multichip_step(m, 128, 128)(*shard, d["arr_4"])
        np.savez({str(tmp_path)!r} + f"/out{{rank}}.npz", i=i, j=j,
                 **dict(zip(("p", "mcells", "qg", "total", "total_passed",
                             "counts"), (t.numpy() for t in out))))
        torch.distributed.destroy_process_group()
    """)
    _run_ranks([[sys.executable, worker, str(r), "{port}"]
                for r in range(4)])

    rm = ref_mesh.make_mesh(4)
    assert tuple(rm.devices.shape) == (pp, dd)
    shard = NamedSharding(rm, P("pairs", "data"))
    step = ref_mesh.build_multichip_step(rm, S_q=128, S_t=128,
                                         use_pallas=False)
    rp, rmc, rqg, rtotal, rpassed, rcounts = step(
        *(jax.device_put(a, shard) for a in inputs[:4]),
        jax.numpy.int32(inputs[4]))
    rp = np.asarray(rp)
    band = wf.stream_band(0, 255, 128, 128).numpy()
    assert int(rtotal) == pp * dd * 3
    for r in range(4):
        got = np.load(tmp_path / f"out{r}.npz")
        i, j = int(got["i"]), int(got["j"])
        assert (i, j) == divmod(r, dd)
        p = got["p"]
        assert p.shape == (3, 255, 128)
        np.testing.assert_array_equal(p[:, band], rp[i, j][:, band])
        ref_mc = (((rp[i, j] & 7) == 0) & band).sum(axis=(1, 2))
        np.testing.assert_array_equal(got["mcells"], ref_mc)
        np.testing.assert_array_equal(got["qg"], np.asarray(rqg)[i, j])
        assert int(got["total"]) == int(rtotal)
        assert int(got["total_passed"]) == int(rpassed)
        np.testing.assert_array_equal(got["counts"], np.asarray(rcounts)[i])
        assert got["mcells"].dtype == got["qg"].dtype == np.int32


def _mesh_pairs(seed=3, n=37):
    """tests/test_parallel.py's MeshAligner problems."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        L = int(rng.integers(100, 400))
        q = rng.integers(0, 4, L).astype(np.int8)
        t = q.copy()
        m = rng.random(L) < 0.1
        t[m] = (t[m] + rng.integers(1, 4, int(m.sum()))) % 4
        pairs.append((q, t[:int(rng.integers(80, L + 1))]))
    return pairs


@pytest.mark.parametrize("ndev", [2, 3])
def test_mesh_aligner_matches_single_device(ndev):
    """MeshAligner over ndev CPU devices: the CIGARs of the single-device
    aligner and of the reference's MeshAligner on its 8-device mesh;
    every device solved a shard."""
    pairs = _mesh_pairs()
    pairs += [(pairs[0][0], pairs[0][1][:0]), (pairs[1][0][:0], pairs[1][1])]
    mesh_al = mesh.MeshAligner(["cpu"] * ndev)
    got = mesh_al.align_batch(pairs)
    assert got == wf.WavefrontAligner(device="cpu").align_batch(pairs)
    rmesh = jax.make_mesh((8,), ("data",), devices=jax.devices()[:8])
    assert got == ref_mesh.MeshAligner(rmesh, use_tpu=False).align_batch(
        pairs)
    assert all(al.device_problems > 0 for al in mesh_al.aligners)
    assert sum(al.device_problems for al in mesh_al.aligners) == 37


def test_mesh_aligner_routes_like_reference():
    """Stragglers (fewer than 2 problems a device) and classes wider than
    GIANT_S_T go to the base aligner; one device is the base aligner."""
    pairs = _mesh_pairs(5, 3)
    mesh_al = mesh.MeshAligner(["cpu", "cpu"])
    assert mesh_al.align_batch(pairs) == \
        wf.WavefrontAligner(device="cpu").align_batch(pairs)
    assert mesh_al.aligners[1].device_problems == 0
    mesh_al.base.GIANT_S_T = 64
    pairs = _mesh_pairs(6, 8)
    assert mesh_al.align_batch(pairs) == \
        wf.WavefrontAligner(device="cpu").align_batch(pairs)
    assert mesh_al.aligners[1].device_problems == 0
    one = mesh.MeshAligner(["cpu"])
    assert one.align_batch(_mesh_pairs()) == \
        wf.WavefrontAligner(device="cpu").align_batch(_mesh_pairs())
    assert one.device == torch.device("cpu")
    with pytest.raises(RuntimeError):
        mesh.MeshAligner(["cuda:7"])


def _planted_fasta(tmp_path, seed, name, n_bg, cut_a, cut_b):
    """tests/test_parallel.py's planted-pair genomes."""
    rng = np.random.default_rng(seed)
    bg = rng.choice(np.array(list("acgt")), n_bg)
    seg = "".join(rng.choice(np.array(list("ACGT")), 1500))
    chrom = ("".join(bg[:cut_a]) + seg + "".join(bg[cut_a:cut_b]) + seg
             + "".join(bg[cut_b:]))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(chrom), 70):
            f.write(chrom[i:i + 70] + "\n")
    return str(fa)


def test_distributed_degenerate(tmp_path):
    """The driver in single-process mode equals the plain pipeline."""
    from sedef_tpu_torch.parallel.distributed import (
        gather_lines, process_info, run_pipeline_distributed)
    assert process_info() == (0, 1)
    assert gather_lines(["a", "b"]) == ["a", "b"]
    fa = _planted_fasta(tmp_path, 2, "chrD", 15000, 3000, 9000)
    al = wf.WavefrontAligner(device="cpu")
    paths = run_pipeline_distributed(fa, str(tmp_path / "outd"),
                                     nbuckets=2, aligner=al)
    rows = open(paths["final"]).read().splitlines()
    assert len(rows) >= 2  # header + the planted identical pair
    single = run_pipeline(fa, str(tmp_path / "outs"), nbuckets=2,
                          aligner=al)
    for stage in ("seeds", "aligned", "final"):
        assert open(paths[stage]).read() == open(single[stage]).read()


_DRIVER = """
    import os
    # exercise the fine-grained unit scheduler: the 30 Kbp chromosome
    # splits into ~3 query-range shards per pair
    os.environ["SEDEF_SHARD_BP"] = "10000"
    from sedef_tpu_torch.ops.wavefront import WavefrontAligner
    from sedef_tpu_torch.parallel.distributed import (
        init_distributed, run_pipeline_distributed)
    pid = int(sys.argv[1])
    stop = sys.argv[3] if len(sys.argv) > 3 else None
    init_distributed("localhost:" + sys.argv[2], 2, pid,
                     timeout_s={timeout})
    run_pipeline_distributed({fa!r}, {out!r}, nbuckets=2,
                             aligner=WavefrontAligner(device="cpu"),
                             stop_after=stop)
    torch.distributed.destroy_process_group()
"""


def _singles(fa, tmp_path):
    """final.bed and seeds.bed of the port's and the reference's
    single-process pipelines, which must agree."""
    port = run_pipeline(fa, str(tmp_path / "outs"), nbuckets=2,
                        aligner=wf.WavefrontAligner(device="cpu"))
    ref = ref_run_pipeline(fa, str(tmp_path / "outr"), nbuckets=2,
                           aligner=RefAligner(use_tpu=False))
    out = {}
    for stage in ("seeds", "final"):
        out[stage] = open(port[stage]).read()
        assert out[stage] == open(ref[stage]).read(), stage
    return out


def test_distributed_two_processes(tmp_path):
    """A real 2-process gloo run: final.bed byte-identical to the port's
    and the reference's single-process pipelines."""
    fa = _planted_fasta(tmp_path, 17, "chrZ", 30000, 4000, 14000)
    worker = _worker(tmp_path, _DRIVER.format(
        timeout=GROUP_TIMEOUT_S, fa=fa, out=str(tmp_path / "outd")))
    _run_ranks([[sys.executable, worker, str(i), "{port}"]
                for i in range(2)], attempts=2)
    single = _singles(fa, tmp_path)
    assert open(tmp_path / "outd" / "final.bed").read() == single["final"]
    assert len(single["final"].splitlines()) >= 2


def test_distributed_kill_and_resume(tmp_path):
    """2-process run stopped after the seeds stage, then resumed: the
    resumed run skips stage 1 (collective .ok consensus) and its outputs
    are byte-identical to the single-process pipelines'."""
    fa = _planted_fasta(tmp_path, 23, "chrK", 30000, 4000, 14000)
    outd = tmp_path / "outd"
    worker = _worker(tmp_path, _DRIVER.format(
        timeout=GROUP_TIMEOUT_S, fa=fa, out=str(outd)))

    def run_phase(stop):
        _run_ranks([[sys.executable, worker, str(i), "{port}"]
                    + ([stop] if stop else []) for i in range(2)])

    run_phase("seeds")
    assert (outd / "seeds.bed").exists() and (outd / "seeds.ok").exists()
    assert not (outd / "final.bed").exists()
    seeds_before = open(outd / "seeds.bed").read()
    assert seeds_before.strip(), "stage 1 produced no seeds"
    ok_before = os.stat(outd / "seeds.ok").st_mtime_ns
    run_phase(None)
    assert open(outd / "seeds.bed").read() == seeds_before
    assert os.stat(outd / "seeds.ok").st_mtime_ns == ok_before
    single = _singles(fa, tmp_path)
    assert open(outd / "final.bed").read() == single["final"]
    assert seeds_before == single["seeds"]


def _cli_code(args):
    return ("import runpy, sys\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            f"sys.argv = ['sedef_tpu_torch.cli'] + {list(args)!r}\n"
            "try:\n"
            "    runpy.run_module('sedef_tpu_torch.cli', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n" + _NO_REFERENCE)


def test_cli_distributed_two_processes(tmp_path):
    """The CLI's --coordinator / --num-processes / --process-id drive the
    driver in 2 processes that import neither jax nor the reference;
    final.bed equals the single-process CLI run's and the reference's."""
    fa = _planted_fasta(tmp_path, 31, "chrC", 24000, 4000, 12000)
    env = {**os.environ, "PYTHONPATH": REPO}
    outd = str(tmp_path / "outd")

    def cmd(extra):
        return [sys.executable, "-c", _cli_code(
            ["pipeline", fa, "-o", outd, "-n", "2", "--device", "cpu"]
            + extra)]

    _run_ranks([cmd(["--coordinator", "localhost:{port}",
                     "--num-processes", "2", "--process-id", str(i)])
                for i in range(2)], env=env)
    single = subprocess.run(
        [sys.executable, "-m", "sedef_tpu_torch.cli", "pipeline", fa, "-o",
         str(tmp_path / "outc"), "-n", "2", "--device", "cpu"],
        capture_output=True, env=env, timeout=PROC_TIMEOUT_S)
    assert single.returncode == 0, single.stderr[-1500:]
    got = open(os.path.join(outd, "final.bed")).read()
    assert got == open(tmp_path / "outc" / "final.bed").read()
    assert got == _singles(fa, tmp_path)["final"]
    assert len(got.splitlines()) >= 2


def test_group_that_cannot_form_raises(tmp_path):
    """--num-processes without a reachable group raises within the
    timeout; it never carries on as a single process."""
    worker = _worker(tmp_path, """
        from sedef_tpu_torch.parallel.distributed import (init_distributed,
                                                          process_info)
        try:
            init_distributed("localhost:" + sys.argv[1], 2, 1, timeout_s=3)
        except Exception as e:
            print("RAISED", type(e).__name__)
        else:
            print("FORMED", process_info())
    """)
    r = subprocess.run([sys.executable, worker, _fresh_port()],
                       capture_output=True, text=True,
                       timeout=PROC_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "RAISED" in r.stdout, r.stdout
    with pytest.raises(ValueError):
        from sedef_tpu_torch.parallel.distributed import init_distributed
        init_distributed("localhost:1", 2, None)


def test_lost_peer_fails_the_collective(tmp_path):
    """A peer that leaves the group makes the next gather raise within the
    group's timeout instead of hanging the survivor."""
    worker = _worker(tmp_path, """
        import time
        from sedef_tpu_torch.parallel.distributed import (gather_lines,
                                                          init_distributed)
        pid = int(sys.argv[1])
        init_distributed("localhost:" + sys.argv[2], 2, pid, timeout_s=10)
        assert gather_lines([f"hello {pid}"]) == ["hello 0", "hello 1"]
        if pid == 1:
            os._exit(0)
        t0 = time.time()
        try:
            gather_lines(["again"])
        except Exception as e:
            print("RAISED", type(e).__name__, round(time.time() - t0))
        else:
            print("NO ERROR")
        os._exit(0)
    """.replace("import time", "import os, time"))
    outs = _run_ranks([[sys.executable, worker, str(i), "{port}"]
                       for i in range(2)])
    assert "RAISED" in outs[0], outs[0]


def test_entry_and_dryrun_multichip(tmp_path):
    """``entry("cpu")`` is the plain direct fill, equal to the reference's
    NumPy fill on every problem's band; ``dryrun_multichip(2, "cpu")``
    runs the sharded step on a 2-rank gloo mesh, the miniature pipeline
    with the align stage over 2 devices and the stage-1 passes (the
    prefilter forced on, the sharded and the concurrent sharded search),
    in a process that imports neither jax nor the reference package."""
    from sedef_tpu.ops.wavefront import wavefront_np
    from sedef_tpu_torch.entry import entry
    fn, args = entry("cpu")
    p = fn(*args).numpy()
    band = wf.stream_band(0, 511, 256, 256).numpy()
    for b in range(p.shape[0]):
        p_ref, _ = wavefront_np(args[0][b].numpy(), args[1][b].numpy())
        np.testing.assert_array_equal(p[b][band], p_ref[band])
    code = ("import sys\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            "from sedef_tpu_torch.entry import dryrun_multichip\n"
            "dryrun_multichip(2, 'cpu')\n" + _NO_REFERENCE)
    env = {**os.environ, "PYTHONPATH": REPO, "SEDEF_NATIVE_REGION": "0"}
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True,
                       timeout=PROC_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dryrun_multichip OK: mesh 1x2 on cpu, total=4" in r.stdout
    # part 3: the stage-1 passes on the CPU device, each equal to the host
    assert "dryrun_multichip stage1 on cpu: prefilter pass == host" \
        in r.stdout
    assert "sharded units over 2 devices == host" in r.stdout
    assert "byte-identical" in r.stdout
