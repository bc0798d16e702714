"""Stage 2b on a genome, the regions' alignment (the program's span
``tail.region`` around ``align_stage``): milliseconds summed over the
tail's threads, mean a genome.  The tail runs regions on 8 threads at once,
so this is thread-milliseconds: the tail's metrics add up to more than a
genome's wall time."""

from harness import program

SOURCE = "program_span"
SPAN = "tail.region"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
