"""Stage 1 (``pipeline.search_stage``): its span's milliseconds, mean a
genome of the window."""

SOURCE = "program_span"
SPAN = "pipeline.search_stage"


def read(ctx):
    d = ctx["spans"].get(SPAN)
    return 1e3 * sum(d) / ctx["n"] if d and ctx["n"] else None
