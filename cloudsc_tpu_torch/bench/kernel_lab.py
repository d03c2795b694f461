"""Kernel lab: K1's step time split into stream and compute on the card.

Times the fused CUDA step in its three bodies on the same folded pack, with
the same I/O volume: `full` (the physics), `init` (section 1 only) and
`floor` (ztp1_in + zqv_in: the step's exact loads and stores with
degenerate compute). If full ~= floor + init-like compute, the stream and
the compute run one after the other; if full ~= max(floor, compute), the
stream hides under the compute or the other way round; a floor far under
the bandwidth roof says the stream itself is bound by latency.

`--skip` (comma-joined `scheme.SKIP_TAGS`, one value a run; '' is the full
physics) drops sections from K1's build, so the time a section costs is the
full run's less the run without it. `--fold`, `--foldc`, `--foldn` and
`--foldd` sweep the pack's form (0/1; -1 is CLOUDSC_FOLD_INPUTS / _CURVES
/ _NEWTON / _DEP, defaults 1 / 0 / 1 / 0): the folded pack against the
unfolded one (the raw state and tendencies, summed in the kernel; no
optional rows, so `--fold 0` runs the in-line CUADJTQ whatever the other
three say), streamed saturation-curve rows, the streamed ZDQS row against
the in-line CUADJTQ, streamed deposition rows. `--foldo` sweeps the output
rows (1: the four derivable flux rows left out, as the main path; 0: the
kernel writes them; -1: CLOUDSC_FOLD_OUTPUTS). Each (form, output rows,
skip) is a build of its own; the lab builds them all at once before
timing.

Timing: one warm-up launch (its wall time is `build_s`: the library is
loaded then), then `--iters` back-to-back launches between CUDA events.
Nothing is subtracted.

Every record also holds the warm-up launch's outputs against the body's
plain PyTorch version on the same pack: `bitwise` (bit for bit, NaNs
included) and `finite` (no NaN or infinity in the kernel's outputs: a skip
that leaves the implicit solve's sums unsolved can overflow fp32, and a
time taken on non-finite values may skip work that the full physics runs).

    python -m cloudsc_tpu_torch.bench.kernel_lab [--ngptot 163840 ...]
        [--modes full init floor] [--order cyclic grouped sorted]
        [--precision fp32 fp64] [--skip '' s31 s45r,s45s ...]
        [--fold 0 1] [--foldc 0 1] [--foldn 0 1] [--foldd 0 1]
        [--foldo 0 1] [--iters 10] [--out FILE]

The JAX lab's TPU DMA-shape knobs (--sb, --lps, --tilem) have no
counterpart here: they shape the TPU's DMA blocks.

Exits 1 without a card, and 2 if a build's kernel is not bit for bit with
its plain version.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
    p.add_argument("--skip", nargs="+", default=[""],
                   help="comma-joined section tags to skip, one value a run "
                        "('' = the full physics)")
    for flag, what in (("--fold", "input pack (0: the unfolded one)"),
                       ("--foldc", "saturation-curve rows"),
                       ("--foldn", "ZDQS row (0: the in-line CUADJTQ)"),
                       ("--foldd", "deposition rows"),
                       ("--foldo", "output rows (0: the kernel writes the "
                                   "four derivable flux rows)")):
        p.add_argument(flag, type=int, nargs="+", default=[-1],
                       choices=[-1, 0, 1],
                       help=f"the folded {what} (0/1; -1: the "
                            f"environment's default)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=None, help="write the records as JSON")
    return p.parse_args(argv)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaNs and infinities included."""
    ints = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(ints), b.view(ints))


def plain(p, c, mode: str, fold_outputs: bool = True):
    """The plain PyTorch version of body `mode` on pack `p`."""
    from ..kernels import cuda_cloudsc as cc

    if mode == "floor":
        return cc.cloudsc_floor_plain(p, fold_outputs)
    if mode == "init":
        return cc.cloudsc_init_plain(p, c, fold_outputs)
    return cc.cloudsc_fused_plain(p, c, fold_outputs)


def make_pack(inp, params, order: str, dtype, form=None):
    """The pack in the requested column order and form ({"fold_inputs",
    "fc", "fn", "fd"}, each absent at its default; None is the main
    path's), on the card."""
    from ..data.expand import activity_perm
    from ..kernels.cuda_cloudsc import pack_inputs_raw

    perm = None
    if order == "sorted":
        perm = activity_perm(inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"],
                             inp.ptsphy, params.ydecldp.rlmin)
    return pack_inputs_raw(
        inp, params, dtype=dtype, perm=perm,
        column_order="cyclic" if order == "cyclic" else "grouped",
        **(form or {})).to("cuda")


def forms(a) -> list[dict]:
    """The swept forms: {"fold_inputs", "fc", "fn", "fd"} -> bool, -1 read
    from the environment (cuda_cloudsc.fold_flags); an unfolded form has
    none of the optional rows, so it is swept once."""
    from ..kernels.cuda_cloudsc import fold_flags

    env = fold_flags()

    def pick(v, k):
        return env[k] if v < 0 else bool(v)

    out = []
    for fold in a.fold:
        for fc in a.foldc:
            for fn in a.foldn:
                for fd in a.foldd:
                    f = {"fold_inputs": pick(fold, "fold_inputs"),
                         "fc": pick(fc, "fc"), "fn": pick(fn, "fn"),
                         "fd": pick(fd, "fd")}
                    if not f["fold_inputs"]:
                        f.update(fc=False, fn=False, fd=False)
                    if f not in out:
                        out.append(f)
    return out


def foldos(a) -> list[bool]:
    """The swept output rows, -1 read from the environment."""
    from ..kernels.cuda_cloudsc import fold_outputs_flag

    return list(dict.fromkeys(fold_outputs_flag() if fo < 0 else bool(fo)
                              for fo in a.foldo))


def configs(a) -> list:
    from ..physics import scheme

    return [(skip, scheme.SchemeConfig(
        skip=tuple(t for t in skip.split(",") if t))) for skip in a.skip]


def resources(c, p, mode: str, fold_outputs: bool = True) -> dict:
    """The full body's build on pack `p` with output rows `fold_outputs`:
    ptxas' registers and spills, its dynamic shared memory and blocks an SM
    (cuda_cloudsc.occupancy), and its bound (timing.bound on
    cuda_cloudsc.k1_bytes); empty for the diagnostic bodies."""
    from ..kernels import build
    from ..kernels import cuda_cloudsc as cc

    if mode != "full":
        return {}
    v = cc.kernel_version(c, p.form, fold_outputs)
    lib = build.load_library(version=v)
    t = "f32" if p.pack.dtype == torch.float32 else "f64"
    path = build.build(False, version=v)
    r = build.parse_ptxas((path.parent / "ptxas.log").read_text())[
        f"fused_{t}"]
    occ = cc.occupancy(p.pack.dtype, lib)
    nbytes = cc.k1_bytes(p, fold_outputs)
    ms, by = timing.bound(nbytes, timing.K1_FLOP_PER_COLUMN * p.ncol,
                          "fp32" if t == "f32" else "fp64")
    return dict(registers=r["registers"], spill_stores=r.get("spill_stores"),
                smem_bytes=occ["smem_bytes"],
                blocks_per_sm=occ["blocks_per_sm"], bytes=nbytes,
                bound_ms=ms, bound_by=by)


def prebuild(a, params, ptsphy) -> float:
    """Build every (form, output rows, skip) library of the sweep at once;
    seconds."""
    from ..kernels import build
    from ..kernels import cuda_cloudsc as cc
    from ..physics import scheme

    versions = set()
    for form in forms(a):
        for fo in foldos(a):
            for _, cfg in configs(a):
                c = scheme.derived_consts(params, ptsphy, DTYPES["fp32"],
                                          cfg)
                cc.check_kernel_config(c)
                versions.add(cc.kernel_version(c, form, fo))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(versions)) as ex:
        list(ex.map(lambda v: build.build(False, version=v), versions))
    return time.perf_counter() - t0


def run(a) -> tuple[list[dict], bool]:
    from .. import data
    from ..kernels import cuda_cloudsc as cc
    from ..params import Params
    from ..physics import scheme

    records, all_equal = [], True
    built = False
    for ngptot in a.ngptot:
        inp = data.load_input(data.default_input_path(), ngptot)
        params = Params.from_input(inp)
        if not built:
            print(f"# built the sweep's libraries in "
                  f"{prebuild(a, params, inp.ptsphy):.1f} s", flush=True)
            built = True
        for order in a.order:
            for precision in a.precision:
                dtype = DTYPES[precision]
                for form in forms(a):
                    p = make_pack(inp, params, order, dtype, form)
                    for mode, fo, (skip, cfg) in itertools.product(
                            a.modes, foldos(a), configs(a)):
                        c = scheme.derived_consts(params, inp.ptsphy, dtype,
                                                  cfg)
                        consts = cc.const_vector(c, "cuda")

                        def step():
                            return cc.cloudsc_fused(p, c, consts, mode=mode,
                                                    fold_outputs=fo)

                        t0 = time.perf_counter()
                        got = step()
                        torch.cuda.synchronize()
                        build_s = time.perf_counter() - t0
                        equal = all(same_bits(x, y) for x, y in zip(
                            got, plain(p, c, mode, fo)))
                        finite = all(bool(torch.isfinite(x).all())
                                     for x in got)
                        all_equal &= equal
                        del got
                        ms = timing.event_ms(step, a.iters, warmup=0)
                        rec = dict(ngptot=ngptot, mode=mode, order=order,
                                   precision=precision, skip=skip,
                                   fold=int(form["fold_inputs"]),
                                   foldc=int(form["fc"]),
                                   foldn=int(form["fn"]),
                                   foldd=int(form["fd"]), foldo=int(fo),
                                   rows=len(p.rows), ms_per_step=ms,
                                   cols_per_s=p.ncol / (ms * 1e-3),
                                   build_s=build_s, bitwise=equal,
                                   finite=finite,
                                   **resources(c, p, mode, fo))
                        records.append(rec)
                        print(json.dumps(rec), flush=True)
                    del p
                    torch.cuda.empty_cache()
    return records, all_equal


def main(argv=None) -> int:
    a = parse_args(argv)
    if not timing.require_cuda("kernel_lab"):
        return 1
    timing.header("kernel_lab")
    records, all_equal = run(a)
    if a.out:
        Path(a.out).write_text(json.dumps(records, indent=2))
    if not all_equal:
        print("kernel_lab: a build's kernel differs from its plain version",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
