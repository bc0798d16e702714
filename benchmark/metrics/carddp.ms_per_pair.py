"""The gap DPs the router sent to the card, packing, launches, wait and decode
(the program's span ``gapdp.card``): milliseconds, mean a pair."""

from harness import program

SOURCE = "program_span"
SPAN = "gapdp.card"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
