"""Stage 1 on a genome, the host waiting for the card's prefilter or roll
engine (the program's span ``seed.wait``, on the search's thread):
milliseconds, mean a genome."""

from harness import program

SOURCE = "program_span"
SPAN = "seed.wait"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
