"""step_ms_p95: the 95th percentile of the window's step times: a step's
time is the gap between CUDA events recorded on the card's stream between
consecutive steps with no host sync, and on a mesh the slowest card's. A
per-layer reading: host stalls set it, and they come and go with the
host's load."""

from cellbench.loops import percentile

LAYER = "device"
MOVES = "columns_per_s"


def read(run):
    steps = run.step_ms
    if run.loop != "resident" or not steps:
        return None
    return percentile(steps, 95)
