"""Stage 2b on a pair, the region path's own Python: the self time of the
program's span ``region`` (less its anchors, chaining and gap DPs):
milliseconds, mean a pair."""

from harness import program

SOURCE = "program_span"
SPAN = "region"


def read(ctx):
    return program.ms_per_unit(ctx, SPAN, own=True)
