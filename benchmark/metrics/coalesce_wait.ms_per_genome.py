"""The region threads waiting for the coalescing aligner's round (the
program's span ``coalesce.wait``): milliseconds summed over the threads,
mean a genome.  The tail runs regions on 8 threads at once, so this is
thread-milliseconds: the tail's metrics add up to more than a genome's wall
time."""

from harness import program

SOURCE = "program_span"
SPAN = "coalesce.wait"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
