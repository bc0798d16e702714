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
