"""columns_per_s.fp32: `columns_per_s` in the fp32 cells, a metric of its
own: their step is bound by the host's launches, so it spreads with the
host's load far more than the fp64 cells' and takes a bound of its own."""

LAYER = "end to end"
MOVES = "columns_per_s.fp32"


def read(run):
    if run.loop != "resident":
        return None
    return run.units * run.columns_per_chip * run.chips / run.window_s
