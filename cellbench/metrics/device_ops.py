"""device_ops: the device operations (kernels, copies, fills) one card's
step enqueues, as the port counts them where it issues them: `ops.pack`
(the device pack's copies, casts and stack), `ops.k1` (K1's launch) and
`ops.assemble` (the flux rows' scalings, per-level adds and copies, the
cloud tendencies' zeros and stack), over the steps `cloudsc.step` counts
(`cloudsc_tpu_torch.runtime.tracing`). Every step issues the same, so it
repeats exactly. A program without the registry reads nothing."""

LAYER = "kernels"
MOVES = "columns_per_s"
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
