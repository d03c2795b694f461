"""enqueue_ms: the host time a step takes to issue its work, in ms: the
median over the window's steps of the port's own spans `cloudsc.step`
(the device pack and K1) and `cloudsc.assemble` of that step, summed over
the cards of a mesh (`cloudsc_tpu_torch.runtime.tracing`, host clock
where the work is enqueued). Steps run under the profiler are left out.
In a host-bound step it reads the step; where the card is the slower side
the host blocks in launches once the launch queue is full, and it reads
near the step all the same. A program without the registry reads
nothing."""

import statistics

LAYER = "kernels"
MOVES = "columns_per_s"
SPANS = ("cloudsc.step", "cloudsc.assemble")


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
