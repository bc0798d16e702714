"""The gap DPs the router kept on the host (the program's span ``gapdp.host``,
the native per-problem DP): milliseconds, mean a pair."""

from harness import program

SOURCE = "program_span"
SPAN = "gapdp.host"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN)
