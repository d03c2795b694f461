"""device_ops.fp32: `device_ops` in the fp32 cells, which report
`columns_per_s.fp32`; read as `device_ops` reads it."""

LAYER = "kernels"
MOVES = "columns_per_s.fp32"
COUNTERS = ("ops.pack", "ops.k1", "ops.assemble")


def read(run):
    if run.loop != "resident":
        return None
    try:
        from cloudsc_tpu_torch.runtime import tracing
    except ImportError:
        return None
    steps = tracing.snapshot()["calls"].get("cloudsc.step", 0)
    if steps == 0:
        return None
    return sum(tracing.counter(n) for n in COUNTERS) / steps
