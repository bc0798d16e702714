"""Stage 2b on a pair (``simulate.chain_align``, every subrange a pair
chains): milliseconds, mean a pair."""

SOURCE = "program_span"
SPAN = "simulate.chain_align"


def read(ctx):
    d = ctx["spans"].get(SPAN)
    return 1e3 * sum(d) / ctx["n"] if d and ctx["n"] else None
