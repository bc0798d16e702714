"""The gap-DP roofline counts the recurrence's work against the widest SIMD
peak, so that no implementation of the recurrence can read over 100%."""

import numpy as np
import pytest

from roofline import gapdp, peaks

H100 = peaks.peak("NVIDIA H100 80GB HBM3")

# (S_q, S_t, B, card ms) of every gap-DP kernel on file: PERF.md's table of
# TPU kernels (NVIDIA H100 80GB HBM3, 700 W; CUDA events around one launch,
# the wrapper's host work included), fill and traceback of one shape summed
# where the route launches both; the fastest variant is PR 8's dpx2
KERNELS_ON_FILE = [
    ("direct fill + traceback", 1024, 1024, 64, 0.492 + 0.145),
    ("streamed fill K=2 + traceback", 2048, 2048, 50, 1.616),
    ("tiled checkpoint + refill + walk", 10240, 10240, 4,
     7.927 + 1.965 + 0.314),
    ("streamed tiled", 10240, 10240, 16, 14.804 + 2.455 + 0.374),
    ("dpx2 variant fill", 1024, 1024, 64, 0.425),
    ("direct fill alone", 1024, 1024, 64, 0.492),
]


def test_peak_derivation():
    assert H100["int32_ops_per_s"] == pytest.approx(16.727e12, rel=1e-3)
    assert H100["lanes_per_int32_op_16bit"] == 2


@pytest.mark.parametrize("name,S_q,S_t,B,ms", KERNELS_ON_FILE)
def test_kernels_on_file_read_under_100(name, S_q, S_t, B, ms):
    ql = np.full(B, S_q)
    tl = np.full(B, S_t)
    share = 100 * gapdp.least_seconds(ql, tl, H100) / (ms * 1e-3)
    assert 0 < share < 100, (name, share)


def test_least_time_is_compute_bound_and_linear():
    one = gapdp.least_seconds([1000], [1000], H100)
    two = gapdp.least_seconds([1000, 1000], [1000, 1000], H100)
    assert two == pytest.approx(2 * one)
    ops_time = gapdp.OPS_PER_CELL * 1e6 / (H100["int32_ops_per_s"] * 2)
    assert one == pytest.approx(ops_time)


def test_a_cell_at_the_peak_reads_100():
    """A kernel doing one cell in OPS_PER_CELL lane operations at the full
    two-lane rate reads exactly 100%: the count is the recurrence's."""
    ql, tl = np.full(8, 4096), np.full(8, 4096)
    t = gapdp.OPS_PER_CELL * 8 * 4096 ** 2 / (H100["int32_ops_per_s"] * 2)
    assert 100 * gapdp.least_seconds(ql, tl, H100) / t == pytest.approx(100)


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels


def test_share_reads_only_gap_dp_kernels():
    ctx = {"peak": H100, "gapdp": [(np.array([1000]), np.array([1000]))],
           "trace": _Trace([("fill_owned", 1e-3), ("walk_window_kernel",
                                                   1e-3),
                            ("roll_batch_kernel", 5.0)])}
    least = gapdp.least_seconds([1000], [1000], H100)
    assert gapdp.share(ctx) == pytest.approx(100 * least / 2e-3)
    ctx["trace"] = _Trace([("roll_batch_kernel", 5.0)])
    assert gapdp.share(ctx) is None
