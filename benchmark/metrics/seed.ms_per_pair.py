"""Stage 1 on a pair (``simulate.seed_align``): milliseconds, mean a pair."""

SOURCE = "program_span"
SPAN = "simulate.seed_align"


def read(ctx):
    d = ctx["spans"].get(SPAN)
    return 1e3 * sum(d) / ctx["n"] if d and ctx["n"] else None
