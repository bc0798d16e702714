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


def _stage1_passes(fr, bins, seeds, n_devices: int, device: str) -> str:
    """Part 3: stage 1 on the device and sharded over the devices, each
    pass's seeds equal to the host's (``seeds``)."""
    import os
    import time

    from .config import DEFAULT
    from .io.fasta import FastaReference, generate_translation
    from .models import pipeline as pl
    from .models import seeder
    from .models.genome_sim import simulate_genome, write_fasta
    from .ops import prefilter

    # indexes built once, so that per-unit times measure the schedule
    warm = pl.IndexCache(fr, DEFAULT, use_device=device)
    for b in bins:
        for c in b:
            warm.get(c, False)
            warm.get(c, True)
    # pass A: the whole-job path with the roll prefilter forced on
    old = seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS
    seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS = True, 0
    prefilter.reset_stats()
    try:
        seeds_dev = pl.search_stage(fr, bins, DEFAULT, use_device=device,
                                    jobs=1, cache=warm)
    finally:
        seeder.PREFILTER_ON, seeder.PREFILTER_MIN_STEPS = old
    if seeds_dev != seeds:
        raise AssertionError("device-prefiltered stage 1 != host stage 1")
    stats = dict(prefilter.STATS)
    if not stats["intervals"]:
        raise AssertionError("pass A dispatched no prefilter")
    # pass B (unmeasured): the sharded path once; pass C (measured):
    # serial per-unit times
    for _ in range(2):
        report: list = []
        seeds_sh = pl.search_stage(fr, bins, DEFAULT, use_device=device,
                                   jobs=1, cache=warm, shard_bp=50_000,
                                   unit_report=report)
        if seeds_sh != seeds:
            raise AssertionError("sharded stage 1 != host stage 1")
    # the pool hands units to the next free worker: simulate that from
    # the measured unit times, longest first onto the least-loaded
    # device.  A SIMULATED balance: it assumes n_devices independent
    # workers
    per_dev = [0.0] * n_devices
    for dt in sorted((u[4] for u in report), reverse=True):
        d = min(range(n_devices), key=per_dev.__getitem__)
        per_dev[d] += dt
    eff = (sum(per_dev) / (n_devices * max(per_dev))
           if max(per_dev) > 0 else 1.0)

    # pass D: sharded units run concurrently on a thread pool (bounded by
    # the host's cores) against jobs = 1, on a denser 4 Mbp repeat-rich
    # genome (the 800 Kbp one above is too little stage-1 work to time)
    chroms, _ = simulate_genome(4_000_000, 5, seed=11, n_chroms=2,
                                repeat_families=8, repeat_copies=120,
                                repeat_len=(600, 1200),
                                repeat_div=(0.10, 0.35))
    fa = os.path.join(os.path.dirname(fr.path), "dry_conc.fa")
    write_fasta(fa, chroms)
    frD = FastaReference(fa)
    binsD = generate_translation(frD)
    warmD = pl.IndexCache(frD, DEFAULT, use_device=device)
    for b in binsD:
        for c in b:
            warmD.get(c, False)
            warmD.get(c, True)
    n_workers = min(os.cpu_count() or 2, n_devices)
    t0 = time.perf_counter()
    seeds_1 = pl.search_stage(frD, binsD, DEFAULT, use_device=device,
                              jobs=1, cache=warmD, shard_bp=250_000)
    wall_1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    seeds_n = pl.search_stage(frD, binsD, DEFAULT, use_device=device,
                              jobs=n_workers, cache=warmD, shard_bp=250_000)
    wall_n = time.perf_counter() - t0
    if seeds_n != seeds_1:
        raise AssertionError("concurrent sharded stage 1 != serial")
    return (f"stage1 on {device}: prefilter pass == host "
            f"({stats['pruned_a'] + stats['pruned_b']} of "
            f"{stats['intervals']} intervals pruned, {stats['rows']} "
            f"composition rows); {len(report)} sharded units over "
            f"{n_devices} devices == host, busy-balance efficiency "
            f"{eff:.2f} (SIMULATED from serially measured unit times); "
            f"concurrency: wall {wall_1:.2f}s (jobs=1) -> {wall_n:.2f}s "
            f"(jobs={n_workers} on {os.cpu_count()} cores), byte-identical")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """The reference's dry run, on ``n_devices`` devices (cards, listed
    round-robin where the host has fewer; or CPU devices):

    1. the sharded step (``multichip_step``) on an n-rank gloo mesh, one
       process per rank: total == pp * dd * 2;
    2. the miniature end-to-end pipeline with the align stage sharded
       over the devices by ``MeshAligner``: final.bed equal to the
       single-device run's.  (On the CPU, ``SEDEF_NATIVE_REGION=0`` makes
       the regions reach the aligners at all.)
    3. stage 1 on ``device`` (``cuda``: every card): pass A the whole-job
       path with the roll prefilter forced on; passes B and C the
       query-range sharded path, with the busy-balance efficiency over
       ``n_devices`` simulated from C's unit times; pass D the sharded
       path on a thread pool against one thread.  Every pass's seeds equal
       the host's."""
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
        seeds = pl.search_stage(fr, bins, DEFAULT, use_device=False)
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
        stage1 = _stage1_passes(fr, bins, seeds, n_devices, device)
    msg = (f"dryrun_multichip OK: mesh {pp}x{dd} on {device}, total="
           f"{pp * dd * 2}; e2e pipeline over {n_devices} devices: "
           f"{len(final_mesh)} final SDs == single-device\n"
           f"dryrun_multichip {stage1}")
    print(msg)
    return msg
