"""The streamed fill's plan (``wf.stream_plan``) and the stores its
"parallel" organisation makes, run on the CPU.

* ``stream_plan`` over classes, batch sizes and streams of K: organisation
  ("parallel", or "chain" when forced) and the kernel's plan; forcing;
  what the kernels do not take raises ``ValueError``.  Every class the streamed route can
  produce (S_t of 1,024 to 8,192 lanes, S_q from 128 up to the giant rule,
  K from ``stream_k``, launch groups cut by ``P_BUDGET_BYTES``) gets a plan
  the kernels take.
* The edge-masked stores of "parallel" (``csrc/fill_owned.cuh``'s stream
  mode, ``csrc/tile_fill_cluster.cu``'s MODE_PAR): a model of which bytes
  one problem's threads store, groups of 1, 2 or 4 lanes, a whole group in
  the rows in which all its lanes are in the band and each in-band byte
  alone in the others.  The stream matrix is assembled from each problem's
  plain direct fill (``wavefront_fill_torch``) through that mask into a
  poisoned buffer: every band byte is written exactly once, by its owner,
  no problem touches a byte outside its own band, and the band equals
  ``wavefront_fill_streamed_torch``'s.  Without the mask (the direct
  fill's whole-word stores) a problem would overwrite its neighbours'.

Tolerance: exact equality (integer DP)."""

import numpy as np
import pytest
import torch

from sedef_tpu_torch.ops import wavefront as wf

torch.set_num_threads(1)

POISON = 0xEE  # no direction byte (those are below 32)


# (S_q, S_t, n_streams, K, sms) -> (org, kernel, C, W, lanes)
@pytest.mark.parametrize("shape,want", [
    ((2048, 2048, 25, 2, 132), ("parallel", "owned", 1, 2048, 4)),
    ((1024, 1024, 32, 2, 132), ("parallel", "owned", 1, 1024, 4)),
    ((1024, 1024, 132, 8, 132), ("parallel", "owned", 1, 1024, 4)),
    ((8192, 1024, 17, 2, 132), ("parallel", "owned", 1, 1024, 4)),
    # narrow queries in long streams: "parallel" too (the plan never
    # takes a chain on its own)
    ((128, 1024, 132, 4, 132), ("parallel", "owned", 1, 1024, 4)),
    ((128, 1024, 132, 8, 132), ("parallel", "owned", 1, 1024, 4)),
    ((128, 1024, 132, 16, 132), ("parallel", "owned", 1, 1024, 4)),
    ((256, 1024, 132, 8, 132), ("parallel", "owned", 1, 1024, 4)),
    ((256, 2048, 132, 8, 132), ("parallel", "owned", 1, 2048, 4)),
    # 4,096 lanes: a cluster while 2 C blocks a problem fit the SMs
    ((4096, 4096, 16, 2, 132), ("parallel", "cluster", 4, 1024, 2)),
    ((4096, 4096, 17, 2, 132), ("parallel", "cluster", 2, 2048, 2)),
    ((4096, 4096, 33, 2, 132), ("parallel", "cluster", 2, 2048, 2)),
    ((4096, 4096, 34, 2, 132), ("parallel", "owned", 1, 4096, 4)),
    ((2048, 4096, 66, 2, 132), ("parallel", "owned", 1, 4096, 4)),
    ((6144, 6144, 17, 2, 132), ("parallel", "cluster", 2, 3072, 4)),
    ((8192, 8192, 17, 2, 132), ("parallel", "cluster", 2, 4096, 4)),
    ((8192, 8192, 66, 2, 132), ("parallel", "cluster", 2, 4096, 4)),
    # no streamed class is this narrow: owned lanes stand in for the warp
    ((128, 100, 4, 2, 132), ("parallel", "owned", 1, 100, 4)),
    ((128, 90, 4, 2, 132), ("parallel", "cluster", 1, 92, 1)),
])
def test_stream_plan_derives_the_organisation(shape, want):
    plan = wf.stream_plan(*shape)
    assert (plan.org, plan.fill.org, plan.fill.C, plan.fill.W,
            plan.fill.lanes) == want
    S_q, S_t, n, K, sms = shape
    if S_t > 128:
        # the direct fill's plan of all n * K problems
        assert plan.fill == wf.fill_plan(S_q, S_t, n * K, sms)


# (S_q, S_t, n_streams, K, force) -> (org, kernel, C, W, lanes, N)
@pytest.mark.parametrize("shape,force,want", [
    ((2048, 2048, 25, 2), dict(org="chain"),
     ("chain", "cluster", 4, 512, 2, 32)),
    ((1024, 1024, 132, 8), dict(org="chain"),
     ("chain", "cluster", 1, 1024, 2, 32)),
    ((8192, 8192, 17, 2), dict(org="chain"),
     ("chain", "cluster", 4, 2048, 2, 32)),
    ((2048, 2048, 25, 2), dict(kernel="cluster"),
     ("parallel", "cluster", 2, 1024, 2, 32)),
    ((2048, 2048, 25, 2), dict(kernel="cluster", C=4, N=8),
     ("parallel", "cluster", 4, 512, 2, 8)),
    ((1024, 1018, 25, 2), dict(kernel="cluster", C=1, lanes=1),
     ("parallel", "cluster", 1, 1020, 1, 32)),
    ((2048, 2048, 25, 2), dict(kernel="owned", N=2),
     ("parallel", "owned", 1, 2048, 4, 2)),
    ((4096, 4096, 25, 2), dict(kernel="owned"),
     ("parallel", "owned", 1, 4096, 4, 4)),
    ((2, 301, 3, 3), dict(org="chain"),
     ("chain", "cluster", 1, 304, 1, 32)),
])
def test_stream_plan_forced(shape, force, want):
    plan = wf.stream_plan(*shape, 132, **force)
    assert (plan.org, plan.fill.org, plan.fill.C, plan.fill.W,
            plan.fill.lanes, plan.fill.N) == want


@pytest.mark.parametrize("shape,force", [
    ((2048, 2048, 25, 2), dict(org="pipeline")),
    ((2048, 2048, 25, 2), dict(kernel="warp")),
    ((2048, 2048, 25, 2), dict(org="chain", kernel="owned")),
    ((2048, 2050, 25, 2), dict(kernel="owned")),       # lanes come in fours
    ((2048, 8192, 25, 2), dict(kernel="owned")),       # wider than a block
    ((2048, 8192, 25, 2), dict(kernel="cluster", C=1)),
    ((2048, 2048, 25, 2), dict(kernel="cluster", C=3)),
    ((2048, 2048, 25, 2), dict(kernel="owned", N=3)),
    ((2048, 2048, 25, 2), dict(kernel="cluster", N=3)),
    ((2, 2048, 25, 2), dict(kernel="cluster", lanes=4)),  # S_q < lanes
    ((0, 2048, 25, 2), {}), ((2048, 2048, 0, 2), {}),
    ((2048, 2048, 25, 0), {}),
])
def test_stream_plan_rejects(shape, force):
    with pytest.raises(ValueError):
        wf.stream_plan(*shape, 132, **force)
    with pytest.raises(ValueError):
        wf.stream_plan(2048, 2048, 25, 2, 0)


def _takes(plan: wf.StreamPlan, S_q: int, S_t: int) -> bool:
    """What sedef_fill_streamed accepts: owned lanes (whole 4-lane groups,
    1,024 threads, shared memory) or the cluster fill's plan (csrc
    tile_fill_cluster.cu's ``valid`` and ``run``, a block's shared
    memory)."""
    f = plan.fill
    if f.org == "owned":
        return (plan.org == "parallel" and f.N in (2, 4)
                and S_t % 4 == 0 and S_t <= 4096
                and 24 * S_t + S_q <= wf.FILL_SMEM_BYTES)
    tp = f.tile
    return (f.org == "cluster" and 1 <= tp.C <= wf.TILE_MAX_CLUSTER
            and tp.C & (tp.C - 1) == 0 and tp.W % 4 == 0
            and tp.C * tp.W >= S_t and tp.lanes in wf.TILE_LANES
            and tp.W <= wf.TILE_THREADS * tp.lanes and tp.lanes <= S_q
            and (tp.N == 1 or tp.N % 2 == 0) and tp.ring > 2 * tp.N
            and tp.ring & (tp.ring - 1) == 0
            and tp.smem_bytes <= wf.FILL_SMEM_BYTES)


def _streamed_classes(S_t: int):
    """Every S_q class the aligner pads to that the streamed route keeps
    for S_t (not giant: (S_q + S_t) * S_t within GIANT_P_BYTES)."""
    A = wf.WavefrontAligner
    S_q = 128
    while (S_q + S_t) * S_t <= A.GIANT_P_BYTES:
        yield S_q
        S_q = wf._pad_to_class(S_q + 1)


@pytest.mark.parametrize("S_t", [1024, 2048, 4096, 6144, 8192])
def test_every_streamed_class_gets_a_plan_the_kernels_take(S_t):
    """The launch groups ``_align_device`` makes of n problems of every
    streamed class: n_streams streams of stream_k(n), cut by
    P_BUDGET_BYTES; each gets a "parallel" plan that the kernels take,
    and a "chain" plan when forced."""
    al = wf.WavefrontAligner(device="cpu")
    assert S_t >= al.STREAM_MIN_S_T and S_t <= al.GIANT_S_T
    seen = set()
    for S_q in _streamed_classes(S_t):
        for n in (al.STREAM_MIN_PROBLEMS + 1, 50, 64, 132, 133, 264, 1056,
                  2112, 5000):
            K = al.stream_k(n)
            per_stream = wf._stream_rows(S_q, S_t, K) * S_t
            cap = max(1, al.P_BUDGET_BYTES // per_stream)
            streams = -(-n // K)
            for n_streams in {min(cap, streams), streams % cap or cap}:
                for org in wf.STREAM_ORGS:
                    plan = wf.stream_plan(S_q, S_t, n_streams, K, 132,
                                          org=org)
                    assert plan.org == org
                    assert _takes(plan, S_q, S_t), (S_q, n_streams, K, plan)
                    seen.add((org, plan.fill.org))
                own = wf.stream_plan(S_q, S_t, n_streams, K, 132)
                assert own == wf.stream_plan(S_q, S_t, n_streams, K, 132,
                                             org="parallel")
    assert ("parallel", "owned" if S_t <= 4096 else "cluster") in seen


def test_wrapper_takes_a_plan_and_ignores_it_on_the_cpu():
    """``plan=`` is keyword-only; on CPU tensors the wrapper runs the plain
    streamed fill and counts no launch."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.integers(0, 5, (6, 40)).astype(np.int8))
    t = torch.from_numpy(rng.integers(0, 5, (6, 56)).astype(np.int8))
    n0 = wf.wavefront_fill_streamed.launches
    want = wf.wavefront_fill_streamed_torch(q, t, 3)
    for force in (dict(), dict(org="chain"), dict(kernel="cluster", C=2)):
        plan = wf.stream_plan(40, 56, 2, 3, 132, **force)
        assert torch.equal(wf.wavefront_fill_streamed(q, t, 3, plan=plan),
                           want)
    assert wf.wavefront_fill_streamed.launches == n0
    with pytest.raises(TypeError):
        wf.wavefront_fill_streamed(q, t, 3, 5, -4, 40, 1, plan)


# ---------------------------------------------------------------------------
# The edge-masked stores of "parallel"
# ---------------------------------------------------------------------------

def stores(S_q: int, S_t: int, lanes: int, masked: bool = True
           ) -> np.ndarray:
    """(S_q + S_t - 1, S_t) bool: the bytes of its direction rows that one
    problem's threads store.  A thread owns lanes [t0, t0 + lanes) (t0 a
    multiple of ``lanes``) and stores in the rows in which its group meets
    the band, r in [t0, t0 + S_q + lanes - 1): the whole group where all
    its lanes are in the band (and, S_t no multiple of ``lanes``, inside
    the row) or ``masked`` is off, else each in-band byte alone."""
    n_rows = S_q + S_t - 1
    out = np.zeros((n_rows, S_t), bool)
    vec = S_t % lanes == 0
    for t0 in range(0, S_t, lanes):
        for r in range(t0, min(n_rows, t0 + S_q + lanes - 1)):
            m0 = r - t0
            whole = lanes == 1 or (vec and (not masked
                                            or lanes - 1 <= m0 < S_q))
            for k in range(lanes):
                t = t0 + k
                if t < S_t and (whole or 0 <= m0 - k < S_q):
                    out[r, t] = True
    return out


def assemble(q, t, K: int, lanes: int, masked: bool = True):
    """The stream matrix as "parallel" writes it: each problem's direct
    fill stored through ``stores`` at stream row k * S_q of its stream, in
    a poisoned buffer.  Returns (p, writes: how many problems stored each
    byte, owner: the last problem that did, -1 for none)."""
    S_q, S_t = q.shape[1], t.shape[1]
    n = q.shape[0] // K
    n_rows = wf._stream_rows(S_q, S_t, K)
    direct = wf.wavefront_fill_torch(torch.from_numpy(q),
                                     torch.from_numpy(t)).numpy()
    mask = stores(S_q, S_t, lanes, masked)
    p = np.full((n, n_rows, S_t), POISON, np.uint8)
    writes = np.zeros(p.shape, np.int64)
    owner = np.full(p.shape, -1, np.int64)
    for b in range(n * K):
        s, k = divmod(b, K)
        rows = slice(k * S_q, k * S_q + S_q + S_t - 1)
        p[s, rows][mask] = direct[b][mask]
        writes[s, rows] += mask
        owner[s, rows][mask] = k
    return p, writes, owner


def _problems(rng, S_q, S_t, B):
    q = rng.integers(0, 5, (B, S_q)).astype(np.int8)
    t = rng.integers(0, 5, (B, S_t)).astype(np.int8)
    return q, t


# K of 2, 3 and 16; S_q < S_t, S_q = S_t, S_q > S_t; groups of the owned
# lanes (4) and of the cluster fill (1, 2, 4 lanes), S_t no multiple of 4
# and of 2; S_q shorter than a group
STORE_CASES = [(24, 40, 2, 4), (32, 32, 3, 4), (40, 20, 16, 4),
               (24, 40, 3, 2), (36, 36, 2, 1), (40, 20, 2, 2),
               (17, 30, 3, 4), (33, 29, 2, 2), (20, 21, 16, 4),
               (3, 12, 3, 4), (2, 9, 2, 4)]


@pytest.mark.parametrize("S_q,S_t,K,lanes", STORE_CASES)
def test_masked_stores_write_each_band_byte_once_by_its_owner(S_q, S_t, K,
                                                              lanes):
    rng = np.random.default_rng(S_q * 7 + S_t + K + lanes)
    q, t = _problems(rng, S_q, S_t, 2 * K)
    p, writes, owner = assemble(q, t, K, lanes)
    n_rows = wf._stream_rows(S_q, S_t, K)
    band = wf.stream_band(0, n_rows, S_q, S_t, K).numpy()
    r = np.arange(n_rows)[:, None]
    lane = np.arange(S_t)[None, :]
    k_of = np.where(band, (r - lane) // S_q, -1)
    for s in range(2):
        # every band byte once, by its owner; nothing outside the band
        assert (writes[s][band] == 1).all()
        assert (owner[s][band] == k_of[band]).all()
        assert (writes[s][~band] == 0).all()
        assert (p[s][~band] == POISON).all()
    want = wf.wavefront_fill_streamed_torch(torch.from_numpy(q),
                                            torch.from_numpy(t), K).numpy()
    np.testing.assert_array_equal(p[:, band], want[:, band])


@pytest.mark.parametrize("S_q,S_t,K,lanes", [(24, 40, 2, 4), (32, 32, 3, 2),
                                             (40, 20, 16, 4)])
def test_whole_word_stores_would_touch_a_neighbours_band(S_q, S_t, K,
                                                         lanes):
    """The direct fill's stores (a whole group in every row it meets the
    band) write bytes outside a problem's band, which in the stream layout
    are its neighbours'."""
    rng = np.random.default_rng(S_q + S_t)
    q, t = _problems(rng, S_q, S_t, K)
    _, writes, _ = assemble(q, t, K, lanes, masked=False)
    band = wf.stream_band(0, writes.shape[1], S_q, S_t, K).numpy()
    assert (writes[0][band] > 1).any()


def test_mask_is_the_whole_group_away_from_the_band_edges():
    """Per group and problem only the rows r - t0 in [0, lanes - 2] and
    [S_q, S_q + lanes - 2] store bytes one at a time: the rest of a
    group's rows store its whole word."""
    S_q, S_t, lanes = 64, 48, 4
    masked = stores(S_q, S_t, lanes)
    whole = stores(S_q, S_t, lanes, masked=False)
    for t0 in range(0, S_t, lanes):
        rows = [r - t0 for r in range(masked.shape[0])
                if (masked[r, t0:t0 + lanes] != whole[r, t0:t0 + lanes])
                .any()]
        assert rows == [0, 1, 2, S_q, S_q + 1, S_q + 2], t0
