"""The general generator: the two closed loops a traffic file can name,
driven through the port, and the window around them.

A traffic file (`traffic/<mix>.json`) names its loop and its parameters:

  resident  the state lives on the card as the port's field dict, one
            share a card (`runtime.dist.split_columns`, the rule
            `CloudscDriver.shard` cuts by), in the configuration's
            `layout` (`inputs.LAYOUTS`: the plain columns, or the dwarf's
            NPROMA blocks); a unit is one step on every card:
            `CloudscDriver.step` (the `FusedStep`: `zdqs_kernel` and K1 on
            the dict) on the dict as it is held, then
            `kernels.cuda_cloudsc.assemble`, all 21 outputs on the card.
            Steps run back to back, with no host sync. Every column takes
            its own draw, so no two are equal.
  dwarf     a unit is one whole dwarf run with one driver built once: the
            port's loader on the seeded snapshot written to TMPDIR, then
            `CloudscDriver.run(inp, iterations=1, fetch_outputs=False)` (the
            host pack, H2D, K1, `assemble`, `ungroup`), then the card
            validation the CLI runs, against a reference file the harness
            wrote before the set-up clock started.

Both loops keep the last unit's outputs for the comparison, which runs
after the window, once the peak memory has been read. In the blocked
layout the comparison takes the port's outputs in the same blocks
(`(nblk, ..., nproma)` of each canonical `(..., ncol)`) and un-blocks them,
and the reference reads a flat copy of each share, made from the blocked
dict after the window and freed once that share is compared.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import compare, inputs, reference, trace

# the lower-precision control, (dtype, store) of `reference.step`: fp64's
# step in fp32, and fp32's step with its outputs stored in bfloat16 (a
# whole step in bfloat16 or fp16 gives no finite output to compare)
CONTROL = {"fp64": (torch.float32, None), "fp32": (None, torch.bfloat16)}


@dataclasses.dataclass
class Cell:
    """What a run is asked to do: the cell, its configuration and traffic
    (parsed files), the seed, the window and the devices."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    devices: list

    @property
    def precision(self) -> str:
        return self.config["precision"]

    @property
    def dtype(self):
        return inputs.DTYPES[self.precision]

    @property
    def on_card(self) -> bool:
        return self.devices[0].type == "cuda"

    @property
    def layout(self) -> str:
        return self.config.get("layout", "columns")


class Spans:
    """Host spans from the harness's own files around its calls into the
    program: a `record_function` range (what the trace sees) and the
    host-clock seconds of each call, by name."""

    def __init__(self):
        self.seconds: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def wrap(self, obj, attr: str) -> None:
        """Time every call of `obj.attr` under `cellbench.<attr>`."""
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            with self.span(f"cellbench.{attr}"):
                return fn(*args, **kwargs)

        setattr(obj, attr, timed)


def sync(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Marks:
    """Unit boundaries a card: CUDA events recorded on each card's stream
    between consecutive units, with no host sync (host clock on the CPU)."""

    def __init__(self, devices):
        self.devices = list(dict.fromkeys(devices))
        self.events = [[] for _ in self.devices]

    def mark(self) -> None:
        for i, d in enumerate(self.devices):
            if d.type == "cuda":
                with torch.cuda.device(d):
                    e = torch.cuda.Event(enable_timing=True)
                    e.record()
            else:
                e = time.perf_counter()
            self.events[i].append(e)

    def unit_ms(self) -> list:
        """[card][unit] milliseconds between consecutive marks."""
        out = []
        for evs in self.events:
            if evs and isinstance(evs[0], float):
                out.append([(b - a) * 1e3 for a, b in zip(evs, evs[1:])])
            else:
                out.append([a.elapsed_time(b) for a, b in zip(evs, evs[1:])])
        return out


def _field_names():
    return reference.Outputs._fields


class Loop:
    """Set-up, one unit, and the comparison of a unit's outputs."""

    def __init__(self, cell: Cell, spans: Spans):
        self.cell, self.spans = cell, spans
        cfg = cell.config
        fields, self.scalars = inputs.load_snapshot()
        self.amplitude = cfg["perturbation"]["relative"]
        self.snap = inputs.seeded_snapshot(fields, self.scalars, cell.seed,
                                           self.amplitude)
        self.ptsphy = float(self.scalars["PTSPHY"])
        nlev = int(self.scalars["KLEV"])
        if nlev != cfg["levels"]:
            raise ValueError(f"the snapshot has {nlev} levels, the "
                             f"configuration states {cfg['levels']}")
        self.ref_params = reference.Params.from_snapshot(self.snap,
                                                         self.scalars)
        self.ref_config = reference.SchemeConfig(**cfg["scheme"])
        self.reference_s = 0.0   # harness reference work inside set-up
        # per-unit readings of the port's own (the dwarf mix's): H2D
        # seconds and fields its validation flagged
        self.h2d_s, self.flagged = [], []

    def port_config(self):
        from cloudsc_tpu_torch.physics.scheme import SchemeConfig

        return SchemeConfig(**self.cell.config["scheme"])

    def unit(self):
        raise NotImplementedError

    def reference_inputs(self):
        """(device, field dict, first canonical column) of each share, one
        at a time, as the reference reads them: the same values the program
        read, columns last."""
        raise NotImplementedError

    def canonical(self, out, ref):
        """The port's 21 outputs of a share (`out`) with their columns last,
        as `ref` holds them: in the blocked layout each must have the
        blocked shape of its reference, or the comparison raises naming
        the field, and is un-blocked as the comparison reads it."""
        got = [getattr(out, n) for n in _field_names()]
        if self.cell.layout == "columns":
            return got
        nproma = int(self.cell.config["nproma"])
        for n, g, r in zip(_field_names(), got, ref):
            want = (r.shape[-1] // nproma, *r.shape[:-1], nproma)
            if tuple(g.shape) != want:
                raise ValueError(
                    f"cellbench: the program's {n} has the shape "
                    f"{tuple(g.shape)}; the {self.cell.layout} layout wants "
                    f"{want}")
        return (inputs.from_blocks(g) for g in got)

    def compare(self, outs: list, control: bool = False):
        """The comparison of `outs` (one output tuple a share, in the
        configuration's layout, as `reference_inputs` gives the shares)
        with the reference, stepped over each share whole; with `control`,
        the reference a precision lower (`CONTROL`) stands in the
        program's place and `outs` is not read."""
        cmp = compare.Comparison(_field_names(), self.cell.config["limits"])
        for i, (dev, fields, _) in enumerate(self.reference_inputs()):
            ref = reference.step(fields, self.ref_params, self.ptsphy,
                                 self.ref_config)
            if control:
                dtype, store = CONTROL[self.cell.precision]
                got = reference.step(fields, self.ref_params, self.ptsphy,
                                     self.ref_config, dtype=dtype,
                                     store=store)
            else:
                got = self.canonical(outs[i], ref)
            cmp.add(got, ref)
            del got, ref, fields
        return cmp

    def release(self) -> None:
        """Drop what only the timed path needs before the reference runs."""


class Resident(Loop):
    """The state on the card; a unit is one step on every share."""

    def __init__(self, cell: Cell, spans: Spans):
        super().__init__(cell, spans)
        from cloudsc_tpu_torch.kernels import cuda_cloudsc
        from cloudsc_tpu_torch.params import Params
        from cloudsc_tpu_torch.runtime import dist
        from cloudsc_tpu_torch.runtime.driver import CloudscDriver

        cfg = cell.config
        self.cc = cuda_cloudsc
        params = Params.from_scalars(
            self.scalars, rbeta=self.snap.get("YRECLDP_RBETA"),
            rbetap1=self.snap.get("YRECLDP_RBETAP1"))
        chips = int(cfg["chips"])
        backend = "cuda" if cell.on_card else "auto"
        kw = dict(dtype=cell.dtype, scheme_config=self.port_config(),
                  backend=backend, nproma=int(cfg["nproma"]))
        if chips == 1:
            kw.update(device=cell.devices[0])
        elif cell.on_card:
            kw.update(mesh=True)
        else:
            kw.update(devices=cell.devices)
        self.driver = CloudscDriver(params, self.ptsphy, **kw)
        ncol = int(cfg["columns_per_chip"]) * chips
        self.shares = dist.split_columns(ncol, self.driver.ndevices)
        self.driver.shares = self.shares
        self.payloads = []
        for i, (dev, (a, b)) in enumerate(zip(self.driver.devices,
                                              self.shares)):
            with self.spans.span("cellbench.inputs"):
                self.payloads.append(inputs.field_dict(
                    self.snap, b - a, cell.precision, dev, start=a,
                    amplitude=self.amplitude,
                    generator=inputs.share_generator(cell.seed, i, dev),
                    layout=cell.layout, nproma=int(cfg["nproma"])))
        self.outs = [None] * len(self.payloads)
        self.devices = self.driver.devices

    def unit(self):
        step, c, fo = self.driver.step, self.driver.step.c, \
            self.driver.fold_outputs
        for i, p in enumerate(self.payloads):
            self.outs[i] = None   # let the allocator reuse its blocks
            with self.spans.span("cellbench.step"):
                res = step(p)
            with self.spans.span("cellbench.assemble"):
                self.outs[i] = self.cc.assemble(res, p, c, fo)
            del res
        return self.outs

    def reference_inputs(self):
        flat = self.cell.layout == "columns"
        for d, p, (a, _) in zip(self.devices, self.payloads, self.shares):
            yield d, p if flat else {k: inputs.from_blocks(v)
                                     for k, v in p.items()}, a


class Dwarf(Loop):
    """A unit is one whole dwarf run from the seeded snapshot."""

    def __init__(self, cell: Cell, spans: Spans):
        if cell.layout != "columns":
            raise ValueError(
                f"cellbench: the dwarf loop runs the port's own pack from "
                f"the snapshot file, so it holds no {cell.layout!r} layout")
        super().__init__(cell, spans)
        from cloudsc_tpu_torch import data
        from cloudsc_tpu_torch.params import Params
        from cloudsc_tpu_torch.runtime.driver import CloudscDriver

        cfg = cell.config
        self.data = data
        self.ngptot = int(cfg["columns_per_chip"]) * int(cfg["chips"])
        self.tmp = Path(tempfile.mkdtemp(prefix="cellbench-"))
        self.input_path = self.tmp / "input.npz"
        keep = {k: self.snap[k] for k in inputs.LOADED if k in self.snap}
        inputs.write_snapshot(self.input_path, keep, self.scalars)
        t0 = time.perf_counter()
        self.reference_path = self.tmp / "reference.npz"
        self._write_port_reference(cell.devices[0])
        self.reference_s = time.perf_counter() - t0
        inp = data.load_input(str(self.input_path), self.ngptot)
        backend = "cuda" if cell.on_card else "auto"
        self.driver = CloudscDriver(
            Params.from_input(inp), inp.ptsphy, dtype=cell.dtype,
            device=cell.devices[0], scheme_config=self.port_config(),
            backend=backend, nproma=int(cfg["nproma"]))
        for attr in ("prepare", "shard", "ungroup"):
            self.spans.wrap(self.driver, attr)
        self.devices = self.driver.devices
        self.outs = [None]

    def _write_port_reference(self, device) -> None:
        """The port validates each run against a reference file: the
        reference's outputs for the seeded snapshot, at its width, written
        in the dwarf's names (harness work, outside `setup_s`)."""
        klon = int(self.scalars["KLON"])
        fields = inputs.field_dict(self.snap, klon, "fp64", device)
        out = reference.step(fields, self.ref_params, self.ptsphy,
                             self.ref_config)
        names = {n: n.upper() for n in _field_names()}
        np.savez(self.reference_path,
                 **{names[n]: getattr(out, n).cpu().numpy()
                    for n in _field_names()})

    def unit(self):
        from cloudsc_tpu_torch.validate import device_field_norms, \
            reference_on_device, validate_from_norms

        d = self.driver
        self.outs[0] = None
        with self.spans.span("cellbench.load"):
            inp = self.data.load_input(str(self.input_path), self.ngptot)
        with self.spans.span("cellbench.run"):
            out, timings, _ = d.run(inp, iterations=1, fetch_outputs=False)
        with self.spans.span("cellbench.validate"):
            refs = [reference_on_device(str(self.reference_path), self.ngptot,
                                        dev, self.ngptot, 0, 1, columns=cols)
                    for dev, cols in d.out_shares]
            outs = out if d.ndevices > 1 else [out]
            norms = device_field_norms(outs, refs).cpu().numpy()
            verdict = validate_from_norms(
                norms, self.ngptot, print_table=False,
                work_eps=float(torch.finfo(self.cell.dtype).eps))
            del refs
        self.h2d_s.append(timings.h2d_s)
        self.flagged.append(sum(e.flagged for e in verdict))
        self.outs = outs
        return self.outs

    def reference_inputs(self):
        dev = self.devices[0]
        yield dev, inputs.field_dict(self.snap, self.ngptot,
                                     self.cell.precision, dev), 0

    def release(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


LOOPS = {"resident": Resident, "dwarf": Dwarf}


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""

    loop: str
    chips: int
    columns_per_chip: int
    levels: int
    precision: str
    setup_s: float
    window_s: float
    units: int
    unit_ms: list           # [card][unit]
    spans: dict
    h2d_s: list
    slice: trace.Slice | None
    reference_s: float = 0.0

    @property
    def step_ms(self) -> list:
        """Each unit's time: the slowest card's."""
        return [max(t) for t in zip(*self.unit_ms)]

    def idle_share(self) -> float | None:
        """The share of a unit in which the cards run nothing: 1 less the
        traced device-busy time a unit (the union of the activity's
        intervals, the mean over the cards) over the median unit of the
        window. The profiler's host cost per operation stretches the
        traced slice itself (by 2-4x in a launch-bound loop), so its own
        length is not the unit's."""
        if self.slice is None or not self.step_ms:
            return None
        unit_s = statistics.median(self.step_ms) / 1e3
        return 1.0 - self.slice.mean_busy_s / self.slice.units / unit_s


def percentile(values: list, q: int) -> float:
    """The q-th percentile (statistics.quantiles, inclusive)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def _activities(cell: Cell) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cell.on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def traced_slice(loop: Loop, cell: Cell, cards: list) -> trace.Slice:
    """After the window: one profiled unit to pay the profiler's start-up,
    then the traffic's `trace_units` units traced. The profiler leaves its
    callbacks on every launch once started, which slows a launch-bound
    step for the rest of the process, so it never runs before or inside
    the window."""
    n = int(cell.traffic["trace_units"])
    with torch.profiler.profile(activities=_activities(cell)):
        loop.unit()
        sync(loop.devices)
    with torch.profiler.profile(activities=_activities(cell)) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for _ in range(n):
                loop.unit()
            sync(loop.devices)
    return trace.from_profile(prof, cards, n)


def measure(cell: Cell, setup_clock) -> tuple[Record, Loop]:
    """Set up the cell's loop, warm it up, run the window, and return what
    it measured with the loop (its last outputs still held). `setup_clock`
    gives the seconds since the process started."""
    spans = Spans()
    loop = LOOPS[cell.traffic["loop"]](cell, spans)
    devices = loop.devices
    cards = sorted({d.index for d in devices if d.type == "cuda"}) \
        if cell.on_card else [0]
    loop.unit()                     # builds or loads K1, warms the allocator
    sync(devices)
    spans.seconds.clear()
    loop.h2d_s.clear()
    loop.flagged.clear()
    marks = Marks(devices)
    setup_s = setup_clock() - loop.reference_s
    t0 = time.perf_counter()
    marks.mark()
    units = 0
    while time.perf_counter() - t0 < cell.seconds or units == 0:
        loop.unit()
        units += 1
        marks.mark()
    sync(devices)
    window_s = time.perf_counter() - t0
    unit_ms, seconds = marks.unit_ms(), {k: list(v) for k, v in
                                        spans.seconds.items()}
    h2d_s = list(loop.h2d_s)
    sl = traced_slice(loop, cell, cards) if cell.trace else None
    cfg = cell.config
    rec = Record(
        loop=cell.traffic["loop"], chips=int(cfg["chips"]),
        columns_per_chip=int(cfg["columns_per_chip"]),
        levels=int(cfg["levels"]), precision=cell.precision,
        setup_s=setup_s, window_s=window_s, units=units, unit_ms=unit_ms,
        spans=seconds, h2d_s=h2d_s, slice=sl, reference_s=loop.reference_s)
    return rec, loop
