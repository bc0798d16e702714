"""Gap DPs a card launch group over the window: the ``gapdp`` counter's
``problems.card`` over its launch groups on every route (``groups.*``);
None where the window launched none."""

from harness import program

SOURCE = "program_counter"


def read(ctx):
    c = program.counters(ctx, "gapdp")
    groups = sum(v for k, v in c.items() if k.startswith("groups.")) \
        if c else 0
    return c["problems.card"] / groups if groups else None
