"""The host waiting for a gap-DP launch group's packed paths (the program's
span ``gapdp.card.wait``): milliseconds, mean a pair."""

from harness import program

SOURCE = "program_span"
SPAN = "gapdp.card.wait"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
