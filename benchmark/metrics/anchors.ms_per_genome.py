"""Stage 2b on a genome, the region path's anchors (the program's span
``region.anchors``): milliseconds summed over the tail's threads, mean a
genome.  The tail runs regions on 8 threads at once, so this is
thread-milliseconds: the tail's metrics add up to more than a genome's wall
time."""

from harness import program

SOURCE = "program_span"
SPAN = "region.anchors"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
