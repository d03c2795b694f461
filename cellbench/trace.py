"""The traced slice of a window: a `torch.profiler` trace reduced to what
the per-layer metrics and the result's `breakdown` read.

The harness traces a fixed slice after each `--trace 1` window (a number
of steps or runs the traffic file states), with the device synchronised
before and after it, inside a host span named `cellbench.window`. That
span is the traced window (`window_s`). On each card every device activity
(kernels, copies, fills) inside it counts as busy; `busy_s` is the union of
their intervals, averaged over the cards. An idle gap is labelled by what
the host was doing at its midpoint: the innermost `cellbench.*` span and
the innermost operation open there.
"""

from __future__ import annotations

import collections
import dataclasses

WINDOW = "cellbench.window"
SPAN_PREFIX = "cellbench."
TOP = 10


@dataclasses.dataclass
class Slice:
    """A reduced trace. Times in seconds; per-card lists in card order."""

    window_s: float
    busy_s: list          # union of device intervals, a card
    device_s: list        # summed device activity, a card
    device_ops: list      # [[name, seconds]], the most time first
    idle_gaps: list       # [[label, seconds]], the most time first
    units: int            # steps or runs traced

    @property
    def mean_busy_s(self) -> float:
        return sum(self.busy_s) / len(self.busy_s)

    @property
    def mean_device_s(self) -> float:
        return sum(self.device_s) / len(self.device_s)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _labels(cpu: list, points: list) -> list:
    """For each time in `points`, what the host was doing: the innermost
    harness span and the innermost operation open at that time (events
    `(start, end, name)` of one thread, properly nested)."""
    order = sorted(range(len(points)), key=points.__getitem__)
    events = sorted(cpu, key=lambda e: (e[0], -e[1]))
    out = [None] * len(points)
    stack, i = [], 0
    for j in order:
        t = points[j]
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] < events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        open_ = [e for e in stack if e[0] <= t <= e[1]]
        span = next((e[2] for e in reversed(open_)
                     if e[2].startswith(SPAN_PREFIX) and e[2] != WINDOW),
                    None)
        inner = open_[-1][2] if open_ else None
        if inner is None or inner == WINDOW:
            inner = "python"
        out[j] = inner if span in (None, inner) else f"{span}/{inner}"
    return out


def reduce(cpu: list, device: dict, units: int) -> Slice:
    """`cpu`: [(start, end, name)] of the harness's thread, in seconds;
    `device`: card -> [(start, end, name)]. The window is the `WINDOW`
    span; device activity is clipped to it."""
    w0, w1 = next((a, b) for a, b, n in cpu if n == WINDOW)
    window = w1 - w0
    busy, total, gaps = [], [], []
    by_name = collections.Counter()
    for card in sorted(device):
        ivs = []
        for a, b, name in device[card]:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                ivs.append((a, b))
                by_name[name] += b - a
        merged = _union(ivs)
        busy.append(sum(b - a for a, b in merged))
        total.append(sum(b - a for a, b in ivs))
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        gaps += [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    labels = _labels(cpu, [(a + b) / 2 for a, b in gaps])
    idle = collections.Counter()
    for (a, b), label in zip(gaps, labels):
        idle[label] += (b - a) / len(device)
    return Slice(
        window_s=window, busy_s=busy, device_s=total,
        device_ops=[[n, s] for n, s in by_name.most_common(TOP)],
        idle_gaps=[[n, s] for n, s in idle.most_common(TOP)],
        units=units)


def from_profile(prof, cards: list, units: int) -> Slice:
    """Reduce a finished `torch.profiler.profile` (CPU and CUDA activity)
    whose harness thread holds the `WINDOW` span; `cards` are the device
    indices the run uses."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == WINDOW
               and e.device_type() == DeviceType.CPU)
    thread, base = win.start_thread_id(), win.start_ns()
    cpu, device = [], {c: [] for c in cards}
    for e in events:
        a = (e.start_ns() - base) * 1e-9
        b = a + e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CPU:
            if e.start_thread_id() == thread:
                cpu.append((a, b, e.name()))
        elif e.device_type() == DeviceType.CUDA \
                and not e.name().startswith(SPAN_PREFIX) \
                and e.device_index() in device:
            device[e.device_index()].append((a, b, e.name()))
    return reduce(cpu, device, units)

