"""Stage 1 on a pair, its two minimizer indexes (the program's span
``seed.index`` inside ``simulate.seed_align``): milliseconds, mean a pair."""

from harness import program

SOURCE = "program_span"
SPAN = "seed.index"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
