"""columns_per_s: every column of every step completed in the window,
over the window's host time (the window ends in a synchronize on every
card; on a mesh all cards' columns count)."""

LAYER = "end to end"
MOVES = "columns_per_s"


def read(run):
    if run.loop != "resident":
        return None
    return run.units * run.columns_per_chip * run.chips / run.window_s
