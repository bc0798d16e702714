"""The card route's share of the gap DPs' cells over the window: 100 x the
``gapdp`` counter's ``cells.card`` over ``cells.card`` + ``cells.host``
(the router's counts; degenerate problems have no cells)."""

from harness import program

SOURCE = "program_counter"


def read(ctx):
    return program.card_cells_pct(ctx)
