"""Stage 2b on a pair, the region path's anchors (the program's span
``region.anchors``, ``generate_anchors``): milliseconds, mean a pair."""

from harness import program

SOURCE = "program_span"
SPAN = "region.anchors"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
