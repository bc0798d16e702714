"""Counterpart of the repository root's ``__graft_entry__.py``.

Entry points: a single-device step on the flagship compute and a
multi-device dry run.
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """(fn, example_args) on the flagship compute, the anti-diagonal
    wavefront fill at (256, 256): on a card the streamed fill, 8 streams
    of K = 4 problems (kernel 3's counterpart); on the CPU the plain
    direct fill of 8 problems."""
    from .ops.wavefront import wavefront_fill_streamed, wavefront_fill_torch

    S_q = S_t = 256
    rng = np.random.default_rng(0)
    dev = torch.device(device)
    if dev.type == "cuda":
        K, n_streams = 4, 8
        B = K * n_streams
        qseq = torch.from_numpy(
            rng.integers(0, 4, (B, S_q)).astype(np.int8)).to(dev)
        tgt = torch.from_numpy(
            rng.integers(0, 4, (B, S_t)).astype(np.int8)).to(dev)

        def fn(qseq, tgt):
            return wavefront_fill_streamed(qseq, tgt, K)

        return fn, (qseq, tgt)

    B = 8
    qseq = torch.from_numpy(rng.integers(0, 4, (B, S_q)).astype(np.int8))
    tgt = torch.from_numpy(rng.integers(0, 4, (B, S_t)).astype(np.int8))
    return wavefront_fill_torch, (qseq, tgt)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_rank(rank: int, n: int, port: int, device: str) -> None:
    """One rank of part 1: the sharded step on an n-rank mesh."""
    import torch.distributed as dist

    from .parallel.mesh import example_inputs, make_mesh, multichip_step
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        mesh = make_mesh(n, "cuda" if device == "cuda" else "cpu")
        pp, dd = mesh.mesh.shape
        i, j = divmod(rank, dd)
        dev = (torch.device("cuda", rank % torch.cuda.device_count())
               if device == "cuda" else torch.device("cpu"))
        args = example_inputs(pp, dd)
        shard = [torch.from_numpy(a[i, j]).to(dev) for a in args[:4]]
        step = multichip_step(mesh, 128, 128)
        p, mcells, qg, total, total_passed, counts = step(*shard, args[4])
        if int(total) != pp * dd * 2:
            raise AssertionError((int(total), pp, dd))
        if not 0 <= int(total_passed) <= int(total) or len(counts) != dd:
            raise AssertionError((int(total_passed), counts))
        if not p.any():
            raise AssertionError("empty direction matrices")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """Parts 1 and 2 of the reference's dry run, on ``n_devices`` devices
    (cards, listed round-robin where the host has fewer; or CPU devices):

    1. the sharded step (``multichip_step``) on an n-rank gloo mesh, one
       process per rank: total == pp * dd * 2;
    2. the miniature end-to-end pipeline with the align stage sharded
       over the devices by ``MeshAligner``: final.bed equal to the
       single-device run's.  (On the CPU, ``SEDEF_NATIVE_REGION=0`` makes
       the regions reach the aligners at all.)

    The reference's part 3 runs the stage-1 device passes, which the port
    does not have, and is not here."""
    import tempfile

    import torch.multiprocessing as mp

    from .config import DEFAULT
    from .io.fasta import FastaReference, generate_translation
    from .models import pipeline as pl
    from .models import reporter
    from .models.genome_sim import simulate_genome, write_fasta
    from .ops.wavefront import WavefrontAligner
    from .parallel.mesh import MeshAligner, mesh_shape

    # 1) the sharded step with its collectives, one process per rank
    mp.start_processes(_dryrun_rank, args=(n_devices, _free_port(), device),
                       nprocs=n_devices, join=True, start_method="spawn")
    pp, dd = mesh_shape(n_devices)

    # 2) the miniature pipeline, align stage over the devices
    if device == "cuda":
        n_cards = torch.cuda.device_count()
        devices = [f"cuda:{i % n_cards}" for i in range(n_devices)]
    else:
        devices = ["cpu"] * n_devices
    chroms, _ = simulate_genome(800_000, 6, sd_min=1500, sd_max=6000,
                                seed=5, n_chroms=4)
    with tempfile.TemporaryDirectory() as tmp:
        fa = tmp + "/dry.fa"
        write_fasta(fa, chroms)
        fr = FastaReference(fa)
        bins = generate_translation(fr, max_size=250_000)
        seeds = pl.search_stage(fr, bins, DEFAULT)
        buckets = pl.bucket_stage(seeds, fr, bins, 4, DEFAULT)
        flat = [line for b in buckets for line in b]
        mesh_aligned = pl.canonical_sort_uniq(pl.align_stage(
            flat, fr, DEFAULT, MeshAligner(devices)))
        single_aligned = pl.canonical_sort_uniq(pl.align_stage(
            flat, fr, DEFAULT, WavefrontAligner(device=devices[0])))
        if mesh_aligned != single_aligned:
            raise AssertionError("mesh align != single-device")
        final_mesh = pl.canonical_sort_uniq(
            reporter.stats_rows(mesh_aligned, fr, DEFAULT, jobs=2))
        final_single = pl.canonical_sort_uniq(
            reporter.stats_rows(single_aligned, fr, DEFAULT))
        if final_mesh != final_single or not final_mesh:
            raise AssertionError("mesh final.bed != single-device")
    msg = (f"dryrun_multichip OK: mesh {pp}x{dd} on {device}, total="
           f"{pp * dd * 2}; e2e pipeline over {n_devices} devices: "
           f"{len(final_mesh)} final SDs == single-device")
    print(msg)
    return msg
