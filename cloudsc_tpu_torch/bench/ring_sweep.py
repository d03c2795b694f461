"""Ring sweep: K1 built with other ring geometries, checked and timed.

K1 streams each column's input rows through a ring of S shared-memory
stages (`csrc/cloudsc_fused.cu`); its geometry, the same in both
precisions, is `cuda_cloudsc.RING`. This builds `cloudsc_fused.cu` once for
each geometry `S:BLOCK:MIN_BLOCKS` given (the builds run together, each
into its own directory), and for each precision and
geometry records ptxas' registers and spills, the dynamic shared memory and
the blocks an SM the card gives it (`cuda_cloudsc.occupancy`), whether the
kernel is bitwise equal to its plain version on the pack, and its time: one
warm-up launch, then `--iters` launches between CUDA events. `RING` ships
the geometry that measures fastest (one for both precisions until a sweep
picks different ones).

    python -m cloudsc_tpu_torch.bench.ring_sweep [--geometry 4:128:3 ...]
        [--precision fp32 fp64] [--order sorted] [--ngptot 163840]
        [--foldc 0|1] [--foldn 0|1] [--foldd 0|1] [--iters 10] [--out FILE]

`--foldc/--foldn/--foldd` sweep the build of another form of the pack
(kernel_lab's flags, one value each; the main path's form by default): its
ring holds that form's rows.

Exits 1 without a card, and 2 if a geometry's kernel is not bitwise equal
to the plain version.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import timing
from .kernel_lab import DTYPES, make_pack

GEOMETRIES = ("3:128:2", "4:128:2", "3:128:3", "4:128:3", "3:128:4",
              "4:128:4", "4:64:4", "4:64:6")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m cloudsc_tpu_torch.bench.ring_sweep",
        description="K1 at several ring geometries on one pack.")
    p.add_argument("--geometry", nargs="+", default=list(GEOMETRIES),
                   help="S:BLOCK:MIN_BLOCKS")
    p.add_argument("--precision", nargs="+", default=["fp32", "fp64"],
                   choices=sorted(DTYPES))
    p.add_argument("--order", nargs="+", default=["sorted"],
                   choices=["cyclic", "grouped", "sorted"])
    p.add_argument("--ngptot", type=int, default=163840)
    for flag, default in (("--foldc", 0), ("--foldn", 1), ("--foldd", 0)):
        p.add_argument(flag, type=int, default=default, choices=[0, 1])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=None, help="write the records as JSON")
    return p.parse_args(argv)


def parse_geometry(text: str):
    from ..kernels.cuda_cloudsc import RingGeometry

    parts = text.split(":")
    if len(parts) != 3:
        raise ValueError(f"geometry {text!r}: S:BLOCK:MIN_BLOCKS")
    return RingGeometry(*(int(v) for v in parts))


def run(a) -> tuple[list[dict], bool]:
    from .. import data
    from ..kernels import build
    from ..kernels import cuda_cloudsc as cc
    from ..params import Params
    from ..physics import scheme

    geoms = [parse_geometry(g) for g in a.geometry]
    sources = [build.CSRC / "cloudsc_fused.cu"]
    form = dict(fc=bool(a.foldc), fn=bool(a.foldn), fd=bool(a.foldd))
    version = cc.KernelVersion(**form)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(geoms)) as ex:
        paths = list(ex.map(
            lambda g: build.build(verbose=False, ring=g, sources=sources,
                                  version=version), geoms))
    print(f"# built {len(geoms)} geometries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    libs = [build.load_library(ring=g, sources=sources, version=version)
            for g in geoms]
    ptxas = [build.parse_ptxas((p.parent / "ptxas.log").read_text())
             for p in paths]

    inp = data.load_input(data.default_input_path(), a.ngptot)
    params = Params.from_input(inp)
    records, all_equal = [], True
    for order in a.order:
        for precision in a.precision:
            dtype = DTYPES[precision]
            t = "f32" if dtype == torch.float32 else "f64"
            c = scheme.derived_consts(params, inp.ptsphy, dtype)
            consts = cc.const_vector(c, "cuda")
            p = make_pack(inp, params, order, dtype, form)
            want = cc.cloudsc_fused_plain(p, c)
            for text, g, lib, info in zip(a.geometry, geoms, libs, ptxas):
                occ = cc.occupancy(dtype, lib)
                got = cc.cloudsc_fused(p, c, consts, lib=lib)
                equal = all(torch.equal(x, y) for x, y in zip(got, want))
                all_equal &= equal
                del got
                ms = timing.event_ms(
                    lambda: cc.cloudsc_fused(p, c, consts, lib=lib), a.iters)
                r = info[f"fused_{t}"]
                rec = dict(
                    geometry=text, stages=g.stages, block=g.block,
                    min_blocks=g.min_blocks, precision=precision,
                    order=order, ngptot=a.ngptot, rows=len(p.rows),
                    foldc=a.foldc, foldn=a.foldn, foldd=a.foldd,
                    registers=r["registers"],
                    spill_stores=r.get("spill_stores"),
                    spill_loads=r.get("spill_loads"), stack=r.get("stack"),
                    smem_bytes=occ["smem_bytes"],
                    blocks_per_sm=occ["blocks_per_sm"],
                    warps_per_sm=occ["blocks_per_sm"] * g.block // 32,
                    bitwise=equal, ms_per_step=ms)
                records.append(rec)
                print(json.dumps(rec), flush=True)
            del p, want
            torch.cuda.empty_cache()
    return records, all_equal


def main(argv=None) -> int:
    a = parse_args(argv)
    if not timing.require_cuda("ring_sweep"):
        return 1
    timing.header("ring_sweep")
    records, all_equal = run(a)
    if a.out:
        Path(a.out).write_text(json.dumps(records, indent=2))
    if not all_equal:
        print("ring_sweep: a geometry's kernel differs from the plain "
              "version", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
