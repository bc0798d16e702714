"""Drift guard of the port's foundations against the reference package's,
the analogue of ``tests/test_foundations.py``: config defaults and the
derived parameters, the statistical model (tau, the relaxed-Jaccard
closed form and its table), DNA encoding over every byte, reverse
complement and the ``PackedSeq`` round trip, through both packages on the
same inputs (the index kernel reads ``PackedSeq.code`` / ``cls``).
Tolerance: exact equality, values and dtypes (tau to 1e-12 relative
against its closed form, as the reference's test holds it)."""

import dataclasses
import math

import numpy as np
import pytest

from sedef_tpu import config as ref_config
from sedef_tpu.ops import dna as ref_dna
from sedef_tpu.ops import stat_model as ref_sm
from sedef_tpu_torch import config
from sedef_tpu_torch.ops import dna
from sedef_tpu_torch.ops import stat_model as sm

ALL_BYTES = bytes(range(1, 128)).decode("ascii")


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_config_defaults_match_reference():
    """Every field of every parameter group, the port's against the
    reference package's, and the reference tool's literals
    (globals.cc:16-39)."""
    assert dataclasses.asdict(config.DEFAULT) == \
        dataclasses.asdict(ref_config.DEFAULT)
    assert dataclasses.asdict(config.Config()) == \
        dataclasses.asdict(ref_config.Config())
    c = config.DEFAULT
    assert (c.search.kmer_size, c.search.window_size) == (12, 16)
    assert (c.search.max_error, c.search.max_edit_error) == (0.30, 0.15)
    assert c.search.min_read_size == 700 and c.search.max_sd_size == 1 << 20
    assert (c.align.match, c.align.mismatch, c.align.gap_open,
            c.align.gap_extend) == (5, -4, -40, -1)
    assert c.align.max_ksw_seq_len == 60000
    assert c.chain.max_chain_gap == 210
    assert c.stats.max_scaled_error == 0.5
    assert c.search.error_ratio == ref_config.DEFAULT.search.error_ratio
    assert c.search.max_gap_error == ref_config.DEFAULT.search.max_gap_error


@pytest.mark.parametrize("max_error", [0.20, 0.30, 0.40])
def test_finalize_derives_like_reference(max_error):
    c, r = config.Config(), ref_config.Config()
    c.search.max_error = r.search.max_error = max_error
    c.finalize()
    r.finalize()
    assert dataclasses.asdict(c) == dataclasses.asdict(r)
    assert c.search.min_read_size == int(1000 * (1 - max_error))


@pytest.mark.parametrize("k", [11, 12, 14])
def test_tau_matches_reference(k):
    for e in (0.0, 0.05, 0.15, 0.25, 1.0):
        assert sm.tau(e, k) == ref_sm.tau(e, k)
    expect = (0.85 / 1.15) * 1.0 / (2 * math.exp(1.8) - 1)
    assert sm.tau(0.15, 12) == pytest.approx(expect, rel=1e-12)


@pytest.mark.parametrize("k", [11, 12, 14])
def test_relaxed_jaccard_closed_form_and_table(k):
    """ceil(s * tau) + 1 for s >= 2 (util.cc:85-113), 1 at s = 1, 0 at 0;
    the table (the prefilter's and the roll engine's limit_lut) equal in
    both packages, dtype included."""
    t = sm.tau(0.15, k)
    for s in [0, 1, 2, 10, 44, 100, 160, 320, 1000, 12345]:
        want = 0 if s == 0 else 1 if s == 1 else math.ceil(s * t) + 1
        assert sm.relaxed_jaccard_estimate(s, k) == want
        assert ref_sm.relaxed_jaccard_estimate(s, k) == want
    _same(sm.relaxed_jaccard_table(320, k, config.DEFAULT),
          ref_sm.relaxed_jaccard_table(320, k, ref_config.DEFAULT))


def test_dna_encoding_every_byte():
    """code, cls and the alignment codes of every ASCII byte, both
    packages; the reference tool's classes (hash.cc:65-67)."""
    code, cls = dna.encode(ALL_BYTES)
    rcode, rcls = ref_dna.encode(ALL_BYTES)
    _same(code, rcode)
    _same(cls, rcls)
    _same(dna.encode_align(ALL_BYTES), ref_dna.encode_align(ALL_BYTES))
    _same(dna.uppercase_mask(ALL_BYTES), ref_dna.uppercase_mask(ALL_BYTES))
    code, cls = dna.encode("ACGTacgtNnRr-")
    assert list(code[:8]) == [0, 1, 2, 3, 0, 1, 2, 3]
    assert list(cls) == [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 0, 1, 1]
    assert code.max() <= 3  # the index kernel's 2-bit pack


def test_revcomp_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        s = "".join(rng.choice(list("ACGTacgtNnRrWx-"), 200))
        assert dna.revcomp(s) == ref_dna.revcomp(s)
    assert dna.revcomp(ALL_BYTES) == ref_dna.revcomp(ALL_BYTES)
    assert dna.revcomp("ACGTn") == "NACGT"  # common.h:72-87 maps n to N


@pytest.mark.parametrize("is_rc", [False, True])
def test_packed_seq_roundtrip_matches_reference(is_rc):
    rng = np.random.default_rng(int(is_rc))
    s = "".join(rng.choice(list("ACGTacgtNn"), 500))
    for src in (s, s.encode("ascii"),
                np.frombuffer(s.encode("ascii"), np.uint8)):
        ps = dna.PackedSeq("chr1", src, is_rc=is_rc)
        rs = ref_dna.PackedSeq("chr1", src, is_rc=is_rc)
        assert ps.seq == rs.seq == (dna.revcomp(s) if is_rc else s)
        assert len(ps) == len(rs) == len(s)
        assert ps.sub(2, 60) == rs.sub(2, 60)
        assert ps.is_rc == rs.is_rc == is_rc
        _same(ps.code, rs.code)
        _same(ps.cls, rs.cls)
        _same(ps.align_codes(5, 300), rs.align_codes(5, 300))
