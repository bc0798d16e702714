"""The cluster fill's device time (``csrc/tile_fill_cluster.cu``'s
``tile_fill_cluster``): milliseconds, mean a genome of the window.  That
kernel is the tiled route's checkpoint and refill passes, plain and
streamed, the direct fill's cluster organisation (a class of 4,096 lanes or
more) and the streamed fill's cluster form; None where the window launched
none of them."""

SOURCE = "device_trace"
KERNEL = "tile_fill_cluster"


def read(ctx):
    t = ctx.get("trace")
    if t is None or not ctx["n"]:
        return None
    s = [sec for name, sec in t.kernels if name == KERNEL]
    return 1e3 * sum(s) / ctx["n"] if s else None
