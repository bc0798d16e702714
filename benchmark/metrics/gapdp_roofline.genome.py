"""The gap-DP kernels' share of their roofline over the window: the least
time of every gap DP the card did (``roofline/gapdp.py``) over the device
time the profiler gives their kernels."""

from roofline import gapdp

SOURCE = "device_trace"


def read(ctx):
    return gapdp.share(ctx)
