"""step_ms_p95.fp32: `step_ms_p95` in the fp32 cells, which report
`columns_per_s.fp32`; read as `step_ms_p95` reads it."""

from cellbench.loops import percentile

LAYER = "device"
MOVES = "columns_per_s.fp32"


def read(run):
    steps = run.step_ms
    if run.loop != "resident" or not steps:
        return None
    return percentile(steps, 95)
