"""Spans and counters of the port: one registry a process.

A span times one pass through a layer on the host clock
(`time.perf_counter_ns`): `with span("cloudsc.step"): ...`. Spans nest;
each record holds its name, its parent's name (the innermost span open when
it began, or None), its start and end, and whether a `torch.profiler`
session was recording (`profiled`). The records of a name sit in a ring of
the last `RING`, so a long run cannot grow them; the calls and the total
time of a name count every pass.

While a profiler records, a span also opens a kineto range of its own name
(`torch._C._profiler._RecordFunctionFast`), so the trace's CPU timeline
names the layer on the clock its device activity uses. It never opens a
`record_function` range: kineto copies such a user annotation onto the
device timeline as a CUDA-side event, which a reduction of the trace would
count as device activity. A torch without `_RecordFunctionFast` gets no
range; the host records are kept all the same.

The stack of open spans is the registry's, so spans open from one thread
(the port's host code runs in one). `count(name, n)` adds to an integer
counter; with `key` it adds to one entry of a keyed counter (K1's
launches by build). The spans and counters are always on: a span costs
two clock reads and a ring append, a count an integer add. `snapshot()`
copies both, `reset()` clears both, `summary()` and `table()` give the
operator's view (calls, median and total host ms of each span, every
counter), which the CLI prints under `--profile`.

The names the port records, and what reads each, are listed in PERF.md §3.
"""

from __future__ import annotations

import collections
import statistics
import time

import torch
import torch.autograd.profiler as _autograd_profiler

# records kept a span name
RING = 8192
# the kineto range of a span while a profiler records (torch >= 2.2)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def profiling() -> bool:
    """Whether a `torch.profiler` session is recording."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """One pass through a layer: a context manager that records itself in
    its registry on exit. `seconds` is its duration."""

    __slots__ = ("_registry", "name", "parent", "start_ns", "end_ns",
                 "profiled", "_range")

    def __init__(self, registry: "Registry", name: str):
        self._registry = registry
        self.name = name

    def __enter__(self) -> "Span":
        stack = self._registry.stack
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.profiled = profiling()
        self._range = None
        if self.profiled and _RANGE is not None:
            self._range = _RANGE(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._registry.stack.pop()
        self._registry.record(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Registry:
    """The spans' rings, their calls and total time, and the counters."""

    def __init__(self, ring: int = RING):
        self.ring = ring
        self.stack: list = []       # names of the open spans, innermost last
        self.reset()

    def reset(self) -> None:
        """Clear every record and counter (open spans still close)."""
        self.spans: dict = {}
        self.calls = collections.Counter()
        self.total_ns = collections.Counter()
        self.counters = collections.Counter()

    def span(self, name: str) -> Span:
        return Span(self, name)

    def record(self, s: Span) -> None:
        ring = self.spans.get(s.name)
        if ring is None:
            ring = self.spans[s.name] = collections.deque(maxlen=self.ring)
        ring.append(s)
        self.calls[s.name] += 1
        self.total_ns[s.name] += s.end_ns - s.start_ns

    def count(self, name: str, n: int = 1, key=None) -> None:
        self.counters[name if key is None else (name, key)] += n

    def counter(self, name: str, key=None) -> int:
        return self.counters[name if key is None else (name, key)]

    def keyed(self, name: str) -> dict:
        """{key: count} of the keyed counter `name`."""
        return {k[1]: v for k, v in self.counters.items()
                if isinstance(k, tuple) and k[0] == name}

    def records(self, name: str) -> list:
        """The ring of `name`, oldest first."""
        return list(self.spans.get(name, ()))

    def snapshot(self) -> dict:
        """{"spans": {name: [Span]}, "calls": {name: n}, "counters": {name
        or (name, key): n}}, copies of the registry's."""
        return {"spans": {n: list(r) for n, r in self.spans.items()},
                "calls": dict(self.calls),
                "counters": dict(self.counters)}

    def summary(self) -> dict:
        """The operator's view: {"spans": {name: {"calls", "median_ms" (of
        the ring), "total_ms" (of every call)}}, "counters": {name: n}},
        a keyed counter's entries named `name[key]`."""
        spans = {}
        for name in sorted(self.spans):
            ring = self.spans[name]
            spans[name] = {
                "calls": self.calls[name],
                "median_ms": statistics.median(
                    (s.end_ns - s.start_ns) * 1e-6 for s in ring),
                "total_ms": self.total_ns[name] * 1e-6}
        counters = {(k if isinstance(k, str) else f"{k[0]}[{k[1]}]"): v
                    for k, v in self.counters.items()}
        return {"spans": spans, "counters": dict(sorted(counters.items()))}

    def table(self) -> list:
        """`summary()` as printable lines."""
        s = self.summary()
        lines = [f" {'span':<20s} {'calls':>8s} {'median ms':>12s} "
                 f"{'total ms':>12s}"]
        lines += [f" {name:<20s} {v['calls']:>8d} {v['median_ms']:>12.4f} "
                  f"{v['total_ms']:>12.3f}" for name, v in s["spans"].items()]
        lines += [f" {name} = {v}" for name, v in s["counters"].items()]
        return lines


# the process's registry
REGISTRY = Registry()
span = REGISTRY.span
count = REGISTRY.count
counter = REGISTRY.counter
keyed = REGISTRY.keyed
records = REGISTRY.records
snapshot = REGISTRY.snapshot
reset = REGISTRY.reset
summary = REGISTRY.summary
table = REGISTRY.table
