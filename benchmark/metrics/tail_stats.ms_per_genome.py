"""Stage 3 on a genome, the regions' statistics (the program's span
``tail.stats`` around ``reporter.stats_rows``): milliseconds summed over
the tail's threads, mean a genome.  The tail runs regions on 8 threads at
once, so this is thread-milliseconds: the tail's metrics add up to more
than a genome's wall time."""

from harness import program

SOURCE = "program_span"
SPAN = "tail.stats"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
