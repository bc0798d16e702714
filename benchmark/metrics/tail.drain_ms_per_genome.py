"""Stage 2b align and stage 3 stats that stage 1 did not hide: the span of
``pipeline.OverlappedTail.finish``, milliseconds, mean a genome."""

SOURCE = "program_span"
SPAN = "pipeline.OverlappedTail.finish"


def read(ctx):
    d = ctx["spans"].get(SPAN)
    return 1e3 * sum(d) / ctx["n"] if d and ctx["n"] else None
