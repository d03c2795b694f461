"""Overlap probe: does the stream hide under the compute on the card?

A synthetic stream in K1's layout and schedule (`(nk2, rr, ncol)` fp32,
one thread a column running the level loop, row by row) with a chain of
`--w` dependent fused multiply-adds on every value, measured for each
variant as

    floor     w=0, streaming                      -> stream time S
    resident  level 0 reread at every step, w     -> compute time C
    full      streaming + compute w               -> T

and judged per (variant, w): T against max(S, C) (the stream hides) and
S + C (the two run one after the other). Variants add what K1 does around
its body: `alias` a 3-row k+1 lookahead on the same array, `scratch` 33
rows carried across levels in registers, `prod` both plus a per-column
output, `branchy` the chain under the thread block's data-dependent
predicate (its row-0 max > 0.5).

Timing: one warm-up launch, then `--iters` back-to-back launches between
CUDA events; nothing is subtracted. `gb_per_s` is the array read and
written once (2 x nk2*rr*ncol*4 bytes) over the time, in every mode.

    python -m cloudsc_tpu_torch.bench.overlap_probe [--w 0 4 8 16]
        [--variants plain alias scratch prod branchy] [--ni 320]
        [--sb 1] [--rr 114] [--nk2 23] [--iters 20] [--out FILE]

`--sb` is the thread block's width in 128-column units (1 or 2); the
columns are ni*sb*128.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from ..kernels import cuda_probes as cp
from . import timing


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m cloudsc_tpu_torch.bench.overlap_probe",
        description="Synthetic stream against synthetic compute.")
    p.add_argument("--w", type=int, nargs="+", default=[0, 4, 8, 16],
                   choices=cp.OVERLAP_W)
    p.add_argument("--variants", nargs="+",
                   default=["plain", "alias", "scratch", "prod"],
                   choices=cp.VARIANTS)
    p.add_argument("--ni", type=int, default=320)
    p.add_argument("--nk2", type=int, default=23)
    p.add_argument("--rr", type=int, default=114)
    p.add_argument("--sb", type=int, default=1,
                   choices=range(1, cp.SB_MAX + 1))
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--out", default=None, help="write the records as JSON")
    return p.parse_args(argv)


def measure(x, col, variant, mode, w, sb, iters) -> dict:
    ms = timing.event_ms(lambda: cp.overlap_step(x, col, variant, mode, w, sb),
                         iters)
    nbytes = x.numel() * 4 * 2
    rec = dict(variant=variant, mode=mode, w=w, ms_per_iter=ms,
               gb_per_s=nbytes / (ms * 1e-3) / 1e9)
    print(json.dumps(rec), flush=True)
    return rec


def verdict(records) -> list[str]:
    """Per (variant, w > 0): T against max(S, C) and S + C, and the share
    of the smaller of S and C that the overlap hid."""
    ms = {(r["variant"], r["mode"], r["w"]): r["ms_per_iter"] for r in records}
    lines = []
    for (variant, mode, w), t in ms.items():
        s = ms.get((variant, "full", 0))
        c = ms.get((variant, "resident", w))
        if mode != "full" or w == 0 or s is None or c is None:
            continue
        hidden = (s + c - t) / min(s, c)
        lines.append(f"# verdict {variant} w={w}: T {t:.6f} ms, S {s:.6f}, "
                     f"C {c:.6f}, max(S,C) {max(s, c):.6f}, S+C {s + c:.6f}; "
                     f"hidden share of min(S,C) {hidden:.3f}")
    return lines


def run(a) -> list[dict]:
    ncol = a.ni * a.sb * cp.LANES
    x = torch.ones((a.nk2, a.rr, ncol), device="cuda")
    col = torch.ones(cp.COL_SHAPE, device="cuda")
    records = []
    for variant in a.variants:
        for w in a.w:
            # floor (w=0, streaming); else resident (compute) and full
            modes = ("full",) if w == 0 else ("resident", "full")
            for mode in modes:
                records.append(measure(x, col, variant, mode, w, a.sb,
                                       a.iters))
    for line in verdict(records):
        print(line, flush=True)
    return records


def main(argv=None) -> int:
    a = parse_args(argv)
    if not timing.require_cuda("overlap_probe"):
        return 1
    timing.header("overlap_probe")
    records = run(a)
    if a.out:
        Path(a.out).write_text(json.dumps(records, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
