"""step_ms_p50: the median of the window's step times (as `step_ms_p95`
takes them): the steady step, what the card takes when the host keeps
up."""

from cellbench.loops import percentile

LAYER = "device"
MOVES = "columns_per_s"


def read(run):
    steps = run.step_ms
    if run.loop != "resident" or not steps:
        return None
    return percentile(steps, 50)
