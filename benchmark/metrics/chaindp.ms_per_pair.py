"""Stage 2b on a pair, the region path's chaining DP over its anchors (the
program's span ``region.chain``): milliseconds, mean a pair."""

from harness import program

SOURCE = "program_span"
SPAN = "region.chain"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
