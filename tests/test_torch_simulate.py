"""The port's simulation harness (``models/simulate.py``) against the
reference package: the same seeded SD pairs, the same hit / partial / miss
class for each, and the native full-region core equal to the Python region
path.  Tolerance: exact equality (strings, classes, hits and CIGARs)."""

import random

import pytest
import torch

from sedef_tpu.io.bed import Hit as RefHit
from sedef_tpu.io.bed import SeqRef as RefSeqRef
from sedef_tpu.models import simulate as ref_sim
from sedef_tpu.models.aligner import fast_align as ref_fast_align
from sedef_tpu.ops.wavefront import WavefrontAligner as RefAligner
from sedef_tpu_torch.io.bed import Hit, SeqRef
from sedef_tpu_torch.models import simulate as sim
from sedef_tpu_torch.models.aligner import fast_align
from sedef_tpu_torch.native import lib as native
from sedef_tpu_torch.ops import wavefront as wf

from test_native_region import _rows

torch.set_num_threads(1)


@pytest.mark.parametrize("native_region", ["1", "0"])
@pytest.mark.parametrize("error", [0, 10, 25])
def test_simulation_accuracy(monkeypatch, error, native_region):
    """tests/test_pipeline.py's accuracy harness (>= 4 hits of 5 pairs at
    1.2-6 Kbp per error rate), each pair's class equal to the reference
    package's; with SEDEF_NATIVE_REGION=0 the chains' gap DPs go through
    the port's aligner, every one on its plain PyTorch fill + traceback."""
    monkeypatch.setenv("SEDEF_NATIVE_REGION", native_region)
    if native_region == "0":
        monkeypatch.setattr(wf.WavefrontAligner, "DEVICE_BATCH_MIN", 1)
        monkeypatch.setattr(wf.WavefrontAligner, "DEVICE_BATCH_MIN_CELLS", 0)
    rng, ref_rng = random.Random(100 + error), random.Random(100 + error)
    al = wf.WavefrontAligner(device="cpu")
    ref_al = RefAligner(use_tpu=False)
    got, want = [], []
    for _ in range(5):
        s1, s2, sed = sim.generate_random_sd(rng, error, min_len=1200,
                                             max_len=6000)
        assert (s1, s2, sed) == ref_sim.generate_random_sd(
            ref_rng, error, min_len=1200, max_len=6000)
        got.append(sim.classify_pair(s1, s2, error, aligner=al))
        want.append(ref_sim.classify_pair(s1, s2, error, aligner=ref_al))
    assert got == want
    assert got.count("hit") >= 4, got
    if native_region == "1":
        assert al.device_problems == 0
    elif error:
        assert al.device_problems > 0


@pytest.mark.skipif(not native.has("fast_align"),
                    reason="native lib not built")
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_native_region_matches_python_path(monkeypatch, seed):
    """tests/test_native_region.py's cases, made by the port's mutators:
    the port's native region core, its Python region path and the
    reference's Python region path give the same hits and CIGARs."""
    from test_native_region import _mask_case_and_n
    rng = random.Random(seed)
    al = wf.WavefrontAligner(device="cpu")
    ref_al = RefAligner(use_tpu=False)
    for i in range(12):
        n = rng.randint(900, 6000)
        q = sim.rand_seq(rng, n)
        err = rng.choice([0, 2, 5, 10, 15, 20, 25, 30])
        big = rng.choice([0, 0, 500, 2000])
        r = sim.make_small(rng, q, err)
        if big:
            r = sim.make_large(rng, r, big)
        if i % 3 == 0:
            q = _mask_case_and_n(rng, q)
            r = _mask_case_and_n(rng, r)
        q = sim.rand_seq(rng, 400) + q + sim.rand_seq(rng, 400)
        r = sim.rand_seq(rng, 400) + r + sim.rand_seq(rng, 400)
        same_chr = i % 4 == 0
        name_r = "A" if same_chr else "B"
        span = ((100, 100 + len(r)) if same_chr else (0, len(r)))
        orig = Hit(SeqRef("A", False, len(q)), 0, len(q),
                   SeqRef(name_r, False, len(r)), *span)
        ref_orig = RefHit(RefSeqRef("A", False, len(q)), 0, len(q),
                          RefSeqRef(name_r, False, len(r)), *span)
        monkeypatch.setenv("SEDEF_NATIVE_REGION", "0")
        py = _rows(fast_align(q, r, orig, 11, aligner=al), orig)
        ref_py = _rows(ref_fast_align(q, r, ref_orig, 11, aligner=ref_al),
                       ref_orig)
        monkeypatch.setenv("SEDEF_NATIVE_REGION", "1")
        nat = _rows(fast_align(q, r, orig, 11, aligner=al), orig)
        assert nat == py == ref_py, i


def test_generators_match_reference():
    """The mutators and the coverage helpers, call for call."""
    for seed in range(4):
        a, b = random.Random(seed), random.Random(seed)
        s = sim.rand_seq(a, 3000)
        assert s == ref_sim.rand_seq(b, 3000)
        assert sim.make_small(a, s, 12) == ref_sim.make_small(b, s, 12)
        assert sim.make_large(a, s, 20) == ref_sim.make_large(b, s, 20)
    iv = [(5, 9), (1, 3), (4, 6), (20, 30), (31, 33)]
    assert sim.combine(iv) == ref_sim.combine(iv)
    assert sim.coverage_sum(iv) == ref_sim.coverage_sum(iv)
