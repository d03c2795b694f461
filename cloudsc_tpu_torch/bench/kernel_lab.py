"""Kernel lab: K1's step time split into stream and compute on the card.

Times the fused CUDA step in its three bodies on the same folded pack, with
the same I/O volume: `full` (the physics), `init` (section 1 only) and
`floor` (ztp1_in + zqv_in: the step's exact loads and stores with
degenerate compute). If full ~= floor + init-like compute, the stream and
the compute run one after the other; if full ~= max(floor, compute), the
stream hides under the compute or the other way round; a floor far under
the bandwidth roof says the stream itself is bound by latency.

Timing: one warm-up launch (which builds the kernels on first use; its wall
time is `build_s`), then `--iters` back-to-back launches between CUDA
events. Nothing is subtracted.

    python -m cloudsc_tpu_torch.bench.kernel_lab [--ngptot 163840 ...]
        [--modes full init floor] [--order cyclic grouped sorted]
        [--precision fp32 fp64] [--iters 10] [--out FILE]

The JAX lab's TPU DMA-shape knobs (--sb, --lps, --fold 0, --tilem,
--foldc, --foldd, --foldo) have no counterpart here; --foldn waits for the
kernel's in-line CUADJTQ and --skip for the kernel's SchemeConfig.skip.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import timing

DTYPES = {"fp32": torch.float32, "fp64": torch.float64}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m cloudsc_tpu_torch.bench.kernel_lab",
        description="K1's three bodies (full, init, floor) on one pack.")
    p.add_argument("--ngptot", type=int, nargs="+", default=[163840])
    p.add_argument("--modes", nargs="+", default=["full"],
                   choices=["full", "init", "floor"])
    p.add_argument("--order", nargs="+", default=["cyclic"],
                   choices=["cyclic", "grouped", "sorted"],
                   help="column expansion: cyclic (the JAX lab's default), "
                        "grouped (each source column's copies together), "
                        "sorted (grouped, source columns in activity "
                        "order: the driver's layout)")
    p.add_argument("--precision", nargs="+", default=["fp32"],
                   choices=sorted(DTYPES))
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=None, help="write the records as JSON")
    return p.parse_args(argv)


def make_pack(inp, params, order: str, dtype):
    """The folded pack in the requested column order, on the card."""
    from ..data.expand import activity_perm
    from ..kernels.cuda_cloudsc import pack_inputs_folded

    perm = None
    if order == "sorted":
        perm = activity_perm(inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"],
                             inp.ptsphy, params.ydecldp.rlmin)
    return pack_inputs_folded(
        inp, params, dtype=dtype, perm=perm,
        column_order="cyclic" if order == "cyclic" else "grouped").to("cuda")


def run(a) -> list[dict]:
    from .. import data
    from ..kernels import cuda_cloudsc as cc
    from ..params import Params
    from ..physics import scheme

    records = []
    for ngptot in a.ngptot:
        inp = data.load_input(data.default_input_path(), ngptot)
        params = Params.from_input(inp)
        for order in a.order:
            for precision in a.precision:
                dtype = DTYPES[precision]
                c = scheme.derived_consts(params, inp.ptsphy, dtype)
                consts = cc.const_vector(c, "cuda")
                p = make_pack(inp, params, order, dtype)
                for mode in a.modes:
                    def step():
                        return cc.cloudsc_fused(p, c, consts, mode=mode)

                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    build_s = time.perf_counter() - t0
                    ms = timing.event_ms(step, a.iters, warmup=0)
                    rec = dict(ngptot=ngptot, mode=mode, order=order,
                               precision=precision, ms_per_step=ms,
                               cols_per_s=p.ncol / (ms * 1e-3),
                               build_s=build_s)
                    records.append(rec)
                    print(json.dumps(rec), flush=True)
                del p
                torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    a = parse_args(argv)
    if not timing.require_cuda("kernel_lab"):
        return 1
    timing.header("kernel_lab")
    records = run(a)
    if a.out:
        Path(a.out).write_text(json.dumps(records, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
