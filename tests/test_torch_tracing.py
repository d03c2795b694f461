"""The port's spans and counters (`runtime/tracing.py`) on the CPU:

  * spans nest and name their parents; a name's ring keeps its last
    records while its calls and total count every one; counters, keyed
    counters, `snapshot` and `reset`;
  * under a CPU `torch.profiler` each `cloudsc.*` span is a kineto CPU
    event that is not a user annotation (a `record_function` range would
    be copied onto the device timeline); with no profiler no range opens;
  * `ops.pack` and `ops.assemble` equal the writing aten operations a
    `TorchDispatchMode` sees inside `pack_inputs` and `cloudsc.assemble`
    (views and bare allocations left out); one step on a tiny field dict
    packs nothing, and its device operations repeat over seeds and
    precisions;
  * the benchmark's readers (`cellbench/metrics/enqueue_ms*.py`,
    `device_ops*.py`) read the window's steps and nothing without the
    registry;
  * `CloudscDriver.run` opens its six spans, and `Timings.h2d_s`,
    `compile_s` and `d2h_s` are the durations of `cloudsc.shard`,
    `cloudsc.warmup` and `cloudsc.fetch`; the card's validation
    (`device_field_norms`) opens `cloudsc.validate`.
"""

import collections
import importlib.util
import sys
import types
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cloudsc_tpu_torch import data as tdata
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.params import Params
from cloudsc_tpu_torch.physics.cloudsc import make_inputs
from cloudsc_tpu_torch.runtime import tracing
from cloudsc_tpu_torch.runtime.driver import CloudscDriver
from cloudsc_tpu_torch.validate import device_field_norms, \
    reference_on_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NCOL = 8
# what allocates without writing (a view writes nothing either)
ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided"}
STEP_OPS = ("ops.pack", "ops.k1", "ops.assemble")


@pytest.fixture(scope="module")
def tiny():
    inp = tdata.load_input(tdata.default_input_path(), NCOL)
    return inp, Params.from_input(inp)


def _fields(inp, dtype, seed):
    """The snapshot's field dict, its state perturbed by `seed`."""
    fields = make_inputs(inp, dtype)
    gen = torch.Generator().manual_seed(seed)
    for name in ("pt", "pq", "pa"):
        f = fields[name]
        fields[name] = f * (1 + 1e-3 * torch.rand(f.shape, generator=gen,
                                                  dtype=f.dtype))
    return fields


class LayerWrites(TorchDispatchMode):
    """Writing aten operations, by the innermost open span."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if not func.is_view and name not in ALLOCATIONS:
            stack = tracing.REGISTRY.stack
            self.ops[stack[-1] if stack else None] += 1
        return func(*args, **(kwargs or {}))


def _step_ops() -> int:
    return sum(tracing.counter(n) for n in STEP_OPS)


def test_spans_nest_and_name_their_parents():
    reg = tracing.Registry()
    with reg.span("a") as a:
        with reg.span("b") as b:
            with reg.span("c"):
                pass
        with reg.span("b"):
            pass
    with reg.span("a"):
        pass
    assert [s.parent for s in reg.records("a")] == [None, None]
    assert [s.parent for s in reg.records("b")] == ["a", "a"]
    assert [s.parent for s in reg.records("c")] == ["b"]
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns
    assert a.seconds == (a.end_ns - a.start_ns) * 1e-9 >= 0
    assert reg.stack == []
    s = reg.summary()["spans"]
    assert {n: v["calls"] for n, v in s.items()} == {"a": 2, "b": 2, "c": 1}
    assert not any(r.profiled for n in "abc" for r in reg.records(n))


def test_span_records_and_reraises_on_error():
    reg = tracing.Registry()
    with pytest.raises(ValueError):
        with reg.span("x"):
            raise ValueError
    assert reg.stack == [] and reg.calls["x"] == 1


def test_ring_keeps_the_last_records():
    reg = tracing.Registry(ring=4)
    spans = []
    for _ in range(10):
        with reg.span("s") as s:
            pass
        spans.append(s)
    assert reg.records("s") == spans[-4:]
    assert reg.calls["s"] == 10
    assert reg.total_ns["s"] == sum(s.end_ns - s.start_ns for s in spans)
    assert reg.summary()["spans"]["s"]["calls"] == 10


def test_counters_snapshot_and_reset():
    reg = tracing.Registry()
    reg.count("ops.k1")
    reg.count("ops.k1", 2)
    reg.count("launches.k1.version", key="v1")
    reg.count("launches.k1.version", 3, key="v2")
    with reg.span("s"):
        pass
    assert reg.counter("ops.k1") == 3 and reg.counter("missing") == 0
    assert reg.keyed("launches.k1.version") == {"v1": 1, "v2": 3}
    assert reg.counter("launches.k1.version", "v2") == 3
    snap = reg.snapshot()
    assert snap["counters"]["ops.k1"] == 3 and snap["calls"] == {"s": 1}
    assert reg.summary()["counters"] == {
        "launches.k1.version[v1]": 1, "launches.k1.version[v2]": 3,
        "ops.k1": 3}
    assert any(line.startswith(" s ") for line in reg.table())
    reg.reset()
    assert reg.counter("ops.k1") == 0 and reg.records("s") == []
    assert snap["counters"]["ops.k1"] == 3   # the snapshot is a copy


def test_profiler_ranges_are_cpu_events_not_user_annotations():
    if tracing._RANGE is None:
        pytest.skip("this torch has no _RecordFunctionFast: no range opens")
    from torch.autograd import DeviceType

    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("cloudsc.step"):
            with tracing.span("cloudsc.k1"):
                torch.ones(4).add_(1)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("cloudsc.")]
    assert sorted(e.name() for e in events) == ["cloudsc.k1",
                                                 "cloudsc.step"]
    assert all(e.device_type() == DeviceType.CPU for e in events)
    assert not any(e.is_user_annotation() for e in events)
    assert all(s.profiled for n in ("cloudsc.step", "cloudsc.k1")
               for s in tracing.records(n))


def test_no_range_opens_without_a_profiler(monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, "_RANGE", Range)
    with tracing.span("cloudsc.step") as s:
        pass
    assert opened == [] and not s.profiled
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("cloudsc.step") as s:
            pass
    assert opened == ["cloudsc.step"] and s.profiled


@pytest.mark.parametrize("fold_outputs", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_layer_counts_equal_dispatched_writes(tiny, dtype, fold_outputs):
    inp, params = tiny
    fields = _fields(inp, dtype, 1)
    step = cc.FusedStep(params, inp.ptsphy, dtype, fold_outputs=fold_outputs)
    tracing.reset()
    with LayerWrites() as m:
        cc.assemble(step(fields), fields, step.c, fold_outputs)
        assert tracing.counter("ops.pack") == 0    # the step never packs
        with tracing.span("pack_inputs"):
            p = cc.pack_inputs(fields, params)
    assert tracing.counter("ops.pack") == m.ops["pack_inputs"] > 0
    # the flux rows' writes where the build folds them out; the cloud
    # tendencies are a view of K1's level buffer, which writes nothing
    assert tracing.counter("ops.assemble") == \
        m.ops["cloudsc.assemble"] + m.ops["cloudsc.foldo"]
    assert (tracing.counter("ops.assemble") > 0) == fold_outputs
    assert tracing.counter("ops.k1") == 0      # the plain version launches
    assert tracing.counter("pack_bytes") == p.pack.nbytes + p.col.nbytes
    assert tracing.counter("columns") == NCOL


def test_device_ops_repeat_over_seeds_and_precisions(tiny):
    inp, params = tiny
    per_step = set()
    for dtype in (torch.float32, torch.float64):
        step = cc.FusedStep(params, inp.ptsphy, dtype)
        for seed in (1, 2147483647 + 11):
            fields = _fields(inp, dtype, seed)
            before = _step_ops()
            cc.assemble(step(fields), fields, step.c)
            per_step.add(_step_ops() - before)
    assert len(per_step) == 1
    # no pack; the flux rows' 559 (the CPU path's plain loop: on the card
    # csrc/foldo.cu is one launch, and a step issues 3,
    # tests/test_torch_cuda.py), and none for the cloud tendencies, a view
    # of K1's level buffer (K1 launches nothing on the CPU)
    assert per_step == {559}


def _reader(name):
    path = ROOT / "cellbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("suffix", ["", ".fp32"])
def test_readers_read_the_window(tiny, monkeypatch, suffix):
    inp, params = tiny
    fields = _fields(inp, torch.float32, 3)
    step = cc.FusedStep(params, inp.ptsphy, torch.float32)

    def unit():
        cc.assemble(step(fields), fields, step.c)

    tracing.reset()
    unit()                       # the warm-up, before the window
    marks = len(tracing.records("cloudsc.step"))
    for _ in range(3):           # the window
        unit()
    window = [(s, a) for s, a in zip(tracing.records("cloudsc.step"),
                                     tracing.records("cloudsc.assemble"))
              ][marks:]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        unit()                   # the traced slice
    run = types.SimpleNamespace(loop="resident", units=3, chips=1)
    sums = sorted((s.end_ns - s.start_ns + a.end_ns - a.start_ns) * 1e-6
                  for s, a in window)
    asm = sorted((a.end_ns - a.start_ns) * 1e-6 for _, a in window)
    assert _reader("enqueue_ms" + suffix).read(run) == pytest.approx(
        sums[1], rel=1e-12)
    assert _reader("enqueue_ms.assemble" + suffix).read(run) == \
        pytest.approx(asm[1], rel=1e-12)
    assert _reader("device_ops" + suffix).read(run) == 559
    assert _reader("device_ops" + suffix).read(
        types.SimpleNamespace(loop="dwarf", units=3, chips=1)) is None
    # a program without the registry (the parent's) reads nothing
    monkeypatch.setitem(sys.modules, "cloudsc_tpu_torch.runtime.tracing",
                        None)
    monkeypatch.delattr(sys.modules["cloudsc_tpu_torch.runtime"], "tracing")
    for name in ("enqueue_ms", "enqueue_ms.assemble", "device_ops"):
        assert _reader(name + suffix).read(run) is None


def test_driver_run_opens_its_spans(tiny):
    inp, params = tiny
    drv = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                        device="cpu")
    tracing.reset()
    _, timings, _ = drv.run(inp, iterations=2)
    phases = ("cloudsc.prepare", "cloudsc.shard", "cloudsc.warmup",
              "cloudsc.loop", "cloudsc.ungroup", "cloudsc.fetch")
    for name in phases:
        assert [s.parent for s in tracing.records(name)] == [None], name
    assert [s.parent for s in tracing.records("cloudsc.step")] == \
        ["cloudsc.warmup", "cloudsc.loop", "cloudsc.loop"]
    starts = [tracing.records(n)[0].start_ns for n in phases]
    assert starts == sorted(starts)
    seconds = {n: tracing.records(n)[0].seconds for n in phases}
    assert timings.h2d_s == seconds["cloudsc.shard"]
    assert timings.compile_s == seconds["cloudsc.warmup"]
    assert timings.d2h_s == seconds["cloudsc.fetch"]
    assert tracing.counter("h2d_bytes") > 0
    assert tracing.counter("columns") == 3 * NCOL
    # the card's validation, here on the host's tensors
    out, _, _ = drv.run(inp, fetch_outputs=False)
    assert len(tracing.records("cloudsc.fetch")) == 1
    ref = reference_on_device(tdata.default_reference_path(), NCOL, "cpu")
    device_field_norms(out, ref)
    assert [s.parent for s in tracing.records("cloudsc.validate")] == [None]
