"""The gap DPs the router sent to the card (the program's span
``gapdp.card``): milliseconds summed over the threads, mean a genome.  The
tail runs regions on 8 threads at once, so this is thread-milliseconds: the
tail's metrics add up to more than a genome's wall time."""

from harness import program

SOURCE = "program_span"
SPAN = "gapdp.card"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
