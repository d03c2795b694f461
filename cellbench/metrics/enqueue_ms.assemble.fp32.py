"""enqueue_ms.assemble.fp32: `enqueue_ms.assemble` in the fp32 cells, which
report `columns_per_s.fp32`; read as `enqueue_ms.assemble` reads it."""

import statistics

LAYER = "kernels"
MOVES = "columns_per_s.fp32"
SPANS = ("cloudsc.assemble",)


def read(run):
    if run.loop != "resident":
        return None
    try:
        from cloudsc_tpu_torch.runtime import tracing
    except ImportError:
        return None
    rings = [[s.end_ns - s.start_ns for s in tracing.records(name)
              if not s.profiled] for name in SPANS]
    n = min(run.units * run.chips, *map(len, rings)) // run.chips * run.chips
    if n == 0:
        return None
    ns = [sum(t) for t in zip(*(r[len(r) - n:] for r in rings))]
    return statistics.median(sum(ns[i:i + run.chips])
                             for i in range(0, n, run.chips)) * 1e-6
