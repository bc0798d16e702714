"""Peaks of the cards the benchmark runs on, by ``torch.cuda.get_device_name``.

NVIDIA H100 SXM5 (80GB HBM3): 132 SMs, each issuing 64 int32 operations a
clock (4 sub-partitions x 16 INT32 lanes), at the 1,980 MHz maximum boost
clock: 132 x 64 x 1.98e9 = 16.727e12 int32 operations a second.  The widest
integer SIMD at a 16-bit score is two lanes an int32 operation (the
``*2`` video instructions and Hopper's DPX ``*_s16x2`` forms): 33.454e12
16-bit lane operations a second.  HBM3: 3.35e12 bytes a second (NVIDIA's
data sheet).  Both assume the card's full 700 W power limit; a run reports
the card's name, and PERF.md its power limit beside every share.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int32_ops_per_s": 132 * 64 * 1.98e9,
        "lanes_per_int32_op_16bit": 2,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(kind: str) -> dict | None:
    return PEAKS.get(kind)
