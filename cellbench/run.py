"""Run one benchmark cell once and print its result.

    python3 cellbench/run.py --workload CELL --seed N --seconds S --trace 0|1
    python3 -m cellbench.run ...   (the same)

The cell is an entry of `workloads` in `BENCHMARK.json` at the checkout's
root. Its configuration is `cellbench/configs/<config>.json`, its traffic
`cellbench/traffic/<traffic>.json` (read by `loops`), and each metric a
reader `cellbench/metrics/<metric>.py`: all found by name. With `--trace 0`
the result carries the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, read from the window's steps and from a slice of
steps traced after it.

The last line on stdout is one JSON object: `correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and last
`compared`: each number the comparison read beside its limit. The same
numbers are the last lines on stderr. Without a card, or with fewer cards
than the cell asks for, the run exits 1 and prints no result; so it does
when JAX or the JAX package was loaded by the time the window closed (3),
and when anything fails on the way (a traceback, exit 1).

`--rehearse FILE` is the CPU rehearsal the benchmark's own tests drive: the
cell's configuration and traffic overridden by FILE's `config` and
`traffic` keys (a tiny size, a one-unit traced slice), the plain
PyTorch versions on the CPU, and no device metric printed (each value is
null).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a script, the folder itself would lead the path and its modules
# (trace, inputs) would shadow others: the checkout's root leads instead
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "cloudsc_tpu")


def _age_at_import() -> float:
    """Seconds from this process's start to this module's import (Linux
    /proc, in clock ticks; 0 where /proc cannot say)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start, 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _age_at_import()


def process_age_s() -> float:
    """Seconds since this process started."""
    return _AGE0 + time.perf_counter() - _T0


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name is JAX's, Flax's
    or the JAX package's, compared whole: `cloudsc_tpu_torch` is not
    `cloudsc_tpu`."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"cellbench: no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics this cell reports in this kind of run."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str):
    """The reader module `metrics/<name>.py`, loaded by path (a metric's
    name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cellbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def strict(obj):
    """`obj` with every non-finite float as None, so the line is JSON
    (a comparison of non-finite outputs reads infinity)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: strict(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [strict(v) for v in obj]
    return obj


def power_line() -> str:
    """The card's name and power limit, for the record."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def parse(argv):
    p = argparse.ArgumentParser(prog="cellbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", default=None, metavar="FILE",
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from cellbench import loops

    bench = load_json(ROOT / "BENCHMARK.json")
    w = find_cell(bench, args.workload)
    config = load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    chips = int(w["chips"])
    if int(config["chips"]) != chips:
        raise SystemExit(f"cellbench: {w['config']} states "
                         f"{config['chips']} chips, the cell {chips}")
    rehearse = args.rehearse is not None
    if rehearse:
        tiny = load_json(args.rehearse)
        config = {**config, **tiny.get("config", {})}
        traffic = {**traffic, **tiny.get("traffic", {})}
        devices = [torch.device("cpu")] * chips
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            print(f"cellbench: {args.workload} needs {chips} CUDA "
                  f"device(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}, {have} visible",
                  file=sys.stderr)
            return 1
        devices = [torch.device("cuda", i) for i in range(chips)]
        print(f"# cards: {power_line()}", file=sys.stderr, flush=True)
    cell = loops.Cell(name=args.workload, config=config, traffic=traffic,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), devices=devices)
    rec, loop = loops.measure(cell, process_age_s)
    bad = forbidden_modules()
    if bad:
        print(f"cellbench: loaded by the time the window closed: {bad}",
              file=sys.stderr)
        return 3

    device = {"platform": "cpu" if rehearse else "gpu",
              "kind": "cpu rehearsal" if rehearse
              else torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": 0}
    if not rehearse:
        device["memory_peak_bytes"] = max(
            torch.cuda.max_memory_allocated(d) for d in loop.devices)
    if rec.slice is not None and not rehearse:
        device.update(busy_s=rec.slice.mean_busy_s,
                      window_s=rec.slice.window_s)

    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        value = load_reader(m["name"]).read(rec)
        if value is None:
            continue
        metrics[m["name"]] = {"value": None if rehearse else value,
                              "unit": m["unit"]}

    # the reference, once the window has closed and the peak is read
    outs = loop.outs
    loop.release()
    if not rehearse:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    cmp = loop.compare(outs)
    ref_s = time.perf_counter() - t_ref
    steps = sorted(rec.step_ms)
    print(f"# unit ms: min {steps[0]!r} median {steps[len(steps) // 2]!r} "
          f"p95 {loops.percentile(steps, 95)!r} max {steps[-1]!r}"
          + (f"; all {rec.step_ms!r}" if len(steps) <= 40 else ""),
          file=sys.stderr)
    print(f"# setup_s leaves out {rec.reference_s!r} s of reference work; "
          f"the comparison took {ref_s!r} s after the window "
          f"({rec.units} units in {rec.window_s!r} s)", file=sys.stderr)
    if loop.flagged:
        print(f"# the port's own validation flagged "
              f"{max(loop.flagged)} field(s) at most a run (work done, not "
              f"the verdict)", file=sys.stderr)

    correct = cmp.correct()
    result = {"correct": correct, "attempted": rec.units,
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": device}
    if rec.slice is not None and not rehearse:
        result["breakdown"] = {"device_ops": rec.slice.device_ops,
                               "idle_gaps": rec.slice.idle_gaps}
    result["compared"] = cmp.report()
    for line in cmp.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(strict(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
