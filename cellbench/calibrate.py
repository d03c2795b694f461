"""The readings the comparison's limits are set from, a seed at a time,
in one process: the program's (one unit of the cell's timed path, as the
window runs it, against the reference) and the control's (the reference
a precision lower put in the program's place: for fp64 the step in fp32,
for fp32 the step with its outputs stored in bfloat16; `loops.CONTROL`).

    python3 -m cellbench.calibrate --workload CELL --seeds 11 12 ... \
        [--control] [--traffic MIX] [--out FILE]

Prints one JSON line a seed and reading, and with `--out` writes them all.
Needs the cards the cell asks for, as a run does; `--rehearse FILE` runs
the CPU rehearsal's tiny size instead (the tests' control check).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from cellbench import loops
from cellbench.run import HERE, ROOT, find_cell, load_json


def cell_for(workload: str, seed: int, rehearse: str | None = None,
             traffic: str | None = None):
    bench = load_json(ROOT / "BENCHMARK.json")
    w = find_cell(bench, workload)
    config = load_json(HERE / "configs" / f"{w['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{traffic or w['traffic']}.json")
    chips = int(w["chips"])
    if rehearse:
        tiny = load_json(rehearse)
        config = {**config, **tiny.get("config", {})}
        traffic = {**traffic, **tiny.get("traffic", {})}
        devices = [torch.device("cpu")] * chips
    else:
        devices = [torch.device("cuda", i) for i in range(chips)]
    return loops.Cell(name=workload, config=config, traffic=traffic,
                      seed=seed, seconds=0.0, trace=False, devices=devices)


def readings(workload: str, seed: int, control: bool,
             rehearse: str | None = None,
             traffic: str | None = None) -> list[dict]:
    """[program reading, control reading (with `control`)] for one seed;
    `traffic` puts another mix under the cell's configuration (a second
    path of the program, read as a witness)."""
    cell = cell_for(workload, seed, rehearse, traffic)
    loop = loops.LOOPS[cell.traffic["loop"]](cell, loops.Spans())
    outs = loop.unit()
    loops.sync(loop.devices)
    out = []
    for kind in ("program", "control") if control else ("program",):
        t0 = time.perf_counter()
        cmp = loop.compare(outs, control=kind == "control")
        out.append({"workload": workload, "traffic": cell.traffic["loop"],
                    "seed": seed, "kind": kind,
                    "correct": cmp.correct(), "numbers": cmp.report(),
                    "seconds": time.perf_counter() - t0})
    loop.release()
    del loop, outs
    gc.collect()
    if cell.on_card:
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cellbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--rehearse", default=None)
    p.add_argument("--traffic", default=None)
    args = p.parse_args(argv)
    if args.rehearse is None and not torch.cuda.is_available():
        print("cellbench.calibrate: needs the card", file=sys.stderr)
        return 1
    rows = []
    for seed in args.seeds:
        for r in readings(args.workload, seed, args.control, args.rehearse,
                          args.traffic):
            print(json.dumps(r), flush=True)
            rows.append(r)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
