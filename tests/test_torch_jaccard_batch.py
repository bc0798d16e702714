"""The port's batched sketch intersection
(``sedef_tpu_torch.ops.jaccard_batch``) against the reference package's
(JAX on the CPU) and against brute force, on random sorted INF-padded
rows; the port runs on the CPU device.  Tolerance: exact equality, values
and dtypes (integer counts)."""

import numpy as np
import pytest
import torch

from sedef_tpu.ops import jaccard_batch as ref_jb
from sedef_tpu_torch.ops import jaccard_batch as jb
from sedef_tpu_torch.ops.sliding import SlidingJaccard

torch.set_num_threads(1)


def brute_ideal(q: set[int], r: set[int]) -> int:
    s = len(q)
    union = sorted(q | r)
    window = set(union[:s])
    return len(window & q & r)


def _rows(rng, B, q_hi, r_hi, key_hi):
    qs, rs, expect = [], [], []
    for _ in range(B):
        q = set(rng.integers(0, key_hi, rng.integers(1, q_hi)).tolist())
        r = rng.integers(0, key_hi, rng.integers(0, r_hi))  # duplicates
        qs.append(np.array(sorted(q), dtype=np.int64))
        rs.append(np.sort(r).astype(np.int64))
        expect.append(brute_ideal(q, set(r.tolist())))
    return qs, rs, expect


@pytest.mark.parametrize("seed,B,q_hi,r_hi,key_hi", [
    (0, 40, 60, 120, 500),
    (1, 64, 160, 192, 1 << 12),
    (2, 33, 20, 300, 60),          # dense overlap, many duplicate ref keys
    (3, 16, 100, 100, 3 << 28),    # packed-key range (k = 14: 30 bits)
])
def test_matches_reference_and_bruteforce(seed, B, q_hi, r_hi, key_hi):
    rng = np.random.default_rng(seed)
    qs, rs, expect = _rows(rng, B, q_hi, r_hi, key_hi)
    qa, qsz = jb.windows_to_arrays(qs, q_hi)
    ra = np.full((B, r_hi), jb.INF, np.int32)
    for i, r in enumerate(rs):
        ra[i, :len(r)] = r
    rqa, rqsz = ref_jb.windows_to_arrays(qs, q_hi)
    np.testing.assert_array_equal(qa, rqa)
    np.testing.assert_array_equal(qsz, rqsz)
    got = jb.sketch_intersection(torch.from_numpy(qa), torch.from_numpy(ra),
                                 torch.from_numpy(qsz))
    assert got.dtype == torch.int32
    want = np.asarray(ref_jb.sketch_intersection(qa, ra, qsz))
    assert want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == expect
    # the rank bound switched off: the plain intersection count
    full = np.full(B, q_hi + r_hi, np.int32)
    got_full = jb.merge_rank_intersection(
        torch.from_numpy(qa), torch.from_numpy(ra), torch.from_numpy(full))
    np.testing.assert_array_equal(
        got_full.numpy(),
        np.asarray(ref_jb.merge_rank_intersection(qa, ra, full)))
    assert got_full.tolist() == [len(set(q.tolist()) & set(r.tolist()))
                                 for q, r in zip(qs, rs)]


def test_ideal_bounds_the_incremental_structure():
    """The incremental structure (query first, then refs in random order)
    is at most the ideal: its drift is missed increments only."""
    rng = np.random.default_rng(1)
    for _ in range(30):
        q = sorted(set(rng.integers(0, 1000, 44).tolist()))
        r = sorted(set(rng.integers(0, 1000, 50).tolist()))
        sm = SlidingJaccard(12)
        for k in q:
            sm.add_to_query(k)
        for k in rng.permutation(r).tolist():
            sm.add_to_reference(int(k))
        qa, qsz = jb.windows_to_arrays([np.array(q)], 64)
        ra, _ = jb.windows_to_arrays([np.array(r)], 64)
        ideal = int(jb.sketch_intersection(torch.from_numpy(qa),
                                           torch.from_numpy(ra),
                                           torch.from_numpy(qsz))[0])
        assert ideal == brute_ideal(set(q), set(r))
        assert ideal >= sm.intersection
