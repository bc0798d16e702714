"""Stage 1 on a pair, the host waiting for the card's prefilter or roll engine
(the program's span ``seed.wait``): milliseconds, mean a pair."""

from harness import program

SOURCE = "program_span"
SPAN = "seed.wait"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
