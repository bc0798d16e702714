"""The port's device index build (``sedef_tpu_torch.ops.winnow_device``)
against the reference package's (``sedef_tpu.ops.winnow_device``, JAX on
the CPU) and against the host scan, on the cases of
``tests/test_winnow.py``'s device tests; the port runs on the CPU device.
Tolerance: exact equality, values and dtypes (integer keys and loci)."""

import numpy as np
import pytest
import torch

from sedef_tpu.ops import winnow_device as ref_wd
from sedef_tpu_torch.ops import dna
from sedef_tpu_torch.ops import winnow as winnow_mod
from sedef_tpu_torch.ops import winnow_device as wd
from sedef_tpu_torch.ops.index import MinimizerIndex
from sedef_tpu_torch.ops.winnow import minimizers_np

torch.set_num_threads(1)

CASES = [(0, 12, 16), (1, 12, 16), (2, 11, 8), (3, 5, 4), (4, 14, 32)]


def _random_seq(seed, n):
    rng = np.random.default_rng(seed)
    chars = np.array(list("ACGTacgtNn"))
    probs = np.array([.14, .14, .14, .14, .09, .09, .09, .09, .04, .04])
    return "".join(rng.choice(chars, size=n, p=probs))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _host(code, cls, k, w):
    keys, locs = minimizers_np(code, cls, k, w)
    order = np.argsort(keys, kind="stable")
    return keys, locs, keys[order], locs[order]


@pytest.mark.parametrize("seed,k,w", CASES)
def test_device_index_arrays_match_reference_and_host(seed, k, w):
    code, cls = dna.encode(_random_seq(seed, 5000))
    got = wd.device_index_arrays(code, cls, k, w, device="cpu")
    assert got is not None
    _assert_same(got, ref_wd.device_index_arrays(code, cls, k, w))
    _assert_same(got, _host(code, cls, k, w))


@pytest.mark.parametrize("seed,k,w,drop", [(0, 12, 16, 0), (1, 12, 16, 16),
                                           (2, 11, 8, 8), (4, 14, 32, 0)])
def test_device_index_kernel_matches_reference(seed, k, w, drop):
    """``_device_index`` on one padded segment (N-padded past the valid
    k-mers, as the reference pads a last segment), first and continuation
    segments."""
    n, pad_n = 3000, 4096
    code, cls = dna.encode(_random_seq(seed, n))
    code = np.concatenate([code, np.zeros(pad_n - n, np.uint8)])
    cls = np.concatenate([cls, np.full(pad_n - n, 2, np.uint8)])
    nk_valid = n - k + 1
    cap = (pad_n - k + 1) // 6
    count, locs, keys = wd._device_index(
        torch.from_numpy(code), torch.from_numpy(cls), nk_valid, k, w, cap,
        drop)
    want = ref_wd._device_index(code, cls, np.int32(nk_valid), k, w, cap,
                                np.int32(drop))
    _assert_same([count.numpy(), locs.numpy(), keys.numpy()], want)
    assert 0 < int(count) <= cap


@pytest.mark.parametrize("name,k,w", [("minimizers_7.txt", 12, 16),
                                      ("minimizers_8.txt", 12, 16),
                                      ("minimizers_k11w8.txt", 11, 8)])
def test_device_index_fixture_oracle(fixtures_dir, name, k, w):
    """Device winnow vs the reference-binary golden fixtures."""
    lines = (fixtures_dir / name).read_text().splitlines()
    seq = lines[0][4:]
    expect = []
    for ln in lines[1:]:
        hv, st, loc = ln.split()
        expect.append(((int(st) << (2 * k)) | int(hv), int(loc)))
    code, cls = dna.encode(seq)
    r = wd.device_index_arrays(code, cls, k, w, device="cpu")
    assert r is not None
    assert list(zip(r[0].tolist(), r[1].tolist())) == expect


def test_device_index_multi_segment(monkeypatch):
    """Segments of ``_SEG`` codes with w + k - 1 codes of left context
    stitch to exactly the host result and the reference's, with the
    segment size patched small in both packages."""
    monkeypatch.setattr(wd, "_SEG", 1 << 15)
    monkeypatch.setattr(ref_wd, "_SEG", 1 << 15)
    code, cls = dna.encode(_random_seq(21, 150_000))
    k, w = 12, 16
    got = wd.device_index_arrays(code, cls, k, w, device="cpu")
    assert got is not None
    _assert_same(got, _host(code, cls, k, w))
    _assert_same(got, ref_wd.device_index_arrays(code, cls, k, w))


def test_device_index_returns_none_where_the_reference_does():
    """k > 14, an input with no window, and a capacity overflow (a
    homopolymer emits every k-mer, past 1/6 of them)."""
    code, cls = dna.encode(_random_seq(5, 2000))
    assert wd.device_index_arrays(code, cls, 15, 16, device="cpu") is None
    assert ref_wd.device_index_arrays(code, cls, 15, 16) is None
    code, cls = dna.encode("ACGTACGTACGTACGTACGTACGT")
    assert wd.device_index_arrays(code, cls, 12, 16, device="cpu") is None
    assert ref_wd.device_index_arrays(code, cls, 12, 16) is None
    code, cls = dna.encode("T" * 10_000)
    assert wd.device_index_arrays(code, cls, 12, 16, device="cpu") is None
    assert ref_wd.device_index_arrays(code, cls, 12, 16) is None
    # where it returns None, minimizers() goes on to the NumPy scan
    keys, locs = wd.minimizers_device(*dna.encode("ACGT" * 2000), 12, 16,
                                      device="cpu")
    _assert_same([keys, locs], minimizers_np(*dna.encode("ACGT" * 2000),
                                             12, 16))


@pytest.mark.parametrize("separate_lowercase", [True, False])
def test_minimizer_index_device_build_without_native_winnow(
        monkeypatch, separate_lowercase):
    """``MinimizerIndex(use_device=...)`` builds on the device only where
    the native winnow is absent; the index equals the host build's."""
    seq = _random_seq(9, 20_000)
    host = MinimizerIndex(dna.PackedSeq("c", seq), 12, 16,
                          separate_lowercase=separate_lowercase)
    calls = []
    real = wd.device_index_arrays

    def spy(*a, **kw):
        calls.append(kw["device"] if "device" in kw else a[4])
        return real(*a, **kw)

    monkeypatch.setattr(wd, "device_index_arrays", spy)
    if winnow_mod._native is not None and winnow_mod._native.has("winnow"):
        MinimizerIndex(dna.PackedSeq("c", seq), 12, 16,
                       separate_lowercase=separate_lowercase,
                       use_device="cpu")
        assert calls == []  # the native scan wins where it exists
    monkeypatch.setattr(winnow_mod, "_native", None)
    dev = MinimizerIndex(dna.PackedSeq("c", seq), 12, 16,
                         separate_lowercase=separate_lowercase,
                         use_device="cpu")
    assert calls == ["cpu"]
    for f in ("keys", "locs", "skeys", "slocs"):
        _assert_same([getattr(dev, f)], [getattr(host, f)])
    assert dev.threshold == host.threshold
    k, l = dev.device_arrays("cpu")
    assert k.dtype == l.dtype == torch.int32
    assert dev.device_arrays("cpu")[0] is k  # cached per device
    np.testing.assert_array_equal(k.numpy(), host.keys.astype(np.int32))


def _segment(case):
    """One segment's arguments (code, cls, nk_valid, k, w, cap, drop) as
    ``_run_segments`` passes them, for the edge cases: the ``_MIN_PAD``
    segment of a small input, a continuation segment (drop = w), a
    homopolymer whose emits pass cap, nk_valid cut short, a drop past the
    first tile and a window of one."""
    k, w = 12, 16
    if case == "min_pad":
        code, cls = dna.encode(_random_seq(5, wd._MIN_PAD))
        return code, cls, wd._MIN_PAD - k + 1, k, w, \
            (wd._MIN_PAD - k + 1) // 6, 0
    if case == "overflow":
        code, cls = dna.encode("T" * 3000)
        return code, cls, 3000 - k + 1, k, w, (3000 - k + 1) // 6, 0
    code, cls = dna.encode(_random_seq(6, 6000))
    nk = 6000 - k + 1
    if case == "continuation":
        return code, cls, nk, k, w, nk // 6, w
    if case == "nk_valid_short":
        return code, cls, 3000, k, w, nk // 6, 0
    if case == "drop_past_tile":
        return code, cls, nk, 11, 8, nk // 6, 3000
    return code, cls, nk, 5, 1, nk // 3, 0  # "w1"


SEGMENT_CASES = ["min_pad", "continuation", "overflow", "nk_valid_short",
                 "drop_past_tile", "w1"]


@pytest.mark.parametrize("case", SEGMENT_CASES[:4])
def test_device_index_wrapper_on_cpu_is_plain_and_reference(case):
    """On CPU tensors ``_device_index`` is its plain version and equals
    the reference's jitted op, values and dtypes (count past cap
    included); no kernel is launched."""
    code, cls, nk_valid, k, w, cap, drop = _segment(case)
    T = torch.from_numpy
    before = wd._device_index.launches
    got = wd._device_index(T(code), T(cls), nk_valid, k, w, cap, drop)
    plain = wd._device_index_torch(T(code), T(cls), nk_valid, k, w, cap,
                                   drop)
    want = ref_wd._device_index(code, cls, np.int32(nk_valid), k, w, cap,
                                np.int32(drop))
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    _assert_same([g.numpy() for g in got], want)
    assert (int(got[0]) > cap) == (case == "overflow")
    assert wd._device_index.launches == before


def test_device_index_wrapper_refuses_other_devices():
    m = torch.zeros(64, dtype=torch.uint8, device="meta")
    c = torch.zeros(64, dtype=torch.uint8)
    with pytest.raises(ValueError):
        wd._device_index(m, m, 53, 12, 16, 8)
    with pytest.raises(ValueError):
        wd._device_index(c, m, 53, 12, 16, 8)


def device_index_model(code, cls, nk_valid, k, w, cap, drop,
                       threads=256, scan_threads=1024):
    """``csrc/device_index.cu`` in NumPy: tiles of ``_INDEX_TILE``
    positions, each with the w keys before it (INF before position 0),
    keys by a k-step uint32 loop, window minima by a w-step loop, start
    from the first tile (the last change point at p <= w) unless drop > 0;
    the tile counts, their scan by ``scan_threads`` threads of contiguous
    chunks; each tile's write: a thread's run of TILE / threads positions
    at the tile's offset plus the block's exclusive scan of the runs; the
    slots past the count nk and INF."""
    TILE, INF = wd._INDEX_TILE, wd.INF32
    n = len(code)
    nk = n - k + 1
    nb = -(-nk // TILE)
    emits, tkeys = [], []
    for t in range(nb):
        base, lo = t * TILE, t * TILE - w
        q = lo + np.arange(TILE + w + k - 1)
        held = (q >= 0) & (q < n)
        code_s = np.where(held, code[np.clip(q, 0, n - 1)], 0)
        cls_s = np.where(held, cls[np.clip(q, 0, n - 1)], 0)
        i = np.arange(TILE + w)
        h = np.zeros(TILE + w, np.uint32)
        has_n = np.zeros(TILE + w, bool)
        has_u = np.zeros(TILE + w, bool)
        for j in range(k):
            h = (h << np.uint32(2)) | code_s[i + j].astype(np.uint32)
            has_n |= cls_s[i + j] == 2
            has_u |= cls_s[i + j] == 0
        status = np.where(has_n, 2, np.where(has_u, 0, 1)).astype(np.uint32)
        keys = ((status << np.uint32(2 * k)) | h).view(np.int32)
        keys = np.where((lo + i >= 0) & (lo + i < nk), keys, INF)
        p = base + np.arange(TILE)
        m = np.full(TILE, INF, np.int32)
        for j in range(w):
            m = np.minimum(m, keys[np.arange(TILE) + j])
        cm = (keys[w:w + TILE] <= m) & (p < nk) & (p < nk_valid)
        last = int(p[cm & (p <= w)].max()) if (cm & (p <= w)).any() else -1
        start = drop if drop > 0 else last
        emits.append(cm & (p >= start))
        tkeys.append(keys[w:w + TILE])
    counts = np.array([e.sum() for e in emits], np.int64)
    per = -(-nb // scan_threads)
    chunk = np.array([counts[c * per:(c + 1) * per].sum()
                      for c in range(scan_threads)])
    before = np.cumsum(chunk) - chunk
    off = np.concatenate([before[c] + np.cumsum(counts[c * per:(c + 1) * per])
                          - counts[c * per:(c + 1) * per]
                          for c in range(scan_threads)])[:nb]
    total = int(chunk.sum())
    locs = np.full(cap, nk, np.int32)
    keys_out = np.full(cap, INF, np.int32)
    for t in range(nb):
        run = emits[t].reshape(threads, -1).astype(np.int64)
        tsum = run.sum(1)
        slot = off[t] + (np.cumsum(tsum) - tsum)[:, None] \
            + np.cumsum(run, 1) - run
        sel = (run > 0) & (slot < cap)
        pos = t * TILE + np.arange(TILE).reshape(threads, -1)
        locs[slot[sel]] = pos[sel]
        keys_out[slot[sel]] = tkeys[t].reshape(threads, -1)[sel]
    return np.int32(total), locs, keys_out


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_device_index_model_matches_plain(case):
    """The kernel's tiling, start rule and ordered compaction against the
    plain version's cumsum and scatter."""
    code, cls, nk_valid, k, w, cap, drop = _segment(case)
    want = wd._device_index_torch(torch.from_numpy(code),
                                  torch.from_numpy(cls), nk_valid, k, w,
                                  cap, drop)
    got = device_index_model(code, cls, nk_valid, k, w, cap, drop)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x.numpy())
