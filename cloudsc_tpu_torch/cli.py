"""dwarf-cloudsc-tpu-torch command line entry point.

CLI-compatible with every reference variant: `prog NUMOMP NGPTOT NPROMA`
(ref: src/cloudsc_fortran/dwarf_cloudsc.F90:48-83). NUMOMP has no meaning on
a GPU (accepted for parity), NGPTOT is the global column count and NPROMA
the scan engine's column-padding granularity (the kernel takes any column
count). Prints the reference's config line, throughput table and
validation table, in the format of `python -m cloudsc_tpu`.

`--kernel` picks the engine (`runtime.driver.CloudscDriver`'s backend): the
fused CUDA kernel (auto, cuda; with `--device cpu` auto runs its plain
PyTorch version) or the eager scan engine (scan). The four scheme flags
select the SchemeConfig version, with the JAX CLI's choices and defaults.
On the card the outputs stay there and are validated there (the norms of
`validate.device_field_norms` against the reference expanded on the card);
only the (21, 5) norms reach the host. With `--device cpu`, or with a
reference to write, the host validates the fetched fields. On the card a
line after the validation gives the peak device memory of the run and its
validation (`torch.cuda.max_memory_allocated`), which `bench/sweep.py`
records.
With EC_PMON set in the environment the energy line of `runtime.pmon` (the
card's, from NVML) follows the timing line.

Ranks: launched by `torchrun` (or with RANK, WORLD_SIZE, MASTER_ADDR and
MASTER_PORT set), each process takes its share of NGPTOT and its slice of
the snapshot (`runtime.dist`), one card (LOCAL_RANK modulo the visible
cards, so ranks may share a card) and validates its columns; the norms are
reduced and the perf rows gathered over gloo, and rank 0 alone prints the
config line and the tables. `--mesh` runs every visible card in one
process instead, and is refused under several ranks.

Where this differs from `python -m cloudsc_tpu`: `--debug-nans` checks the
21 outputs of every step for a non-finite value (not every intermediate,
as `jax_debug_nans` does); `--profile` writes a `torch.profiler` Chrome
trace of the timed loop; under several ranks each rank writes its own
`--write-*` file, PATH with `.rank<r>` before the suffix.

Usage:
    python -m cloudsc_tpu_torch 1 163840 128 [--precision fp32|fp64]
        [--device cuda|cpu] [--kernel auto|cuda|scan] [--iwarmrain 1|2]
        [--ievaprain 1|2] [--ievapsnow 1|2] [--idepice 1|2] [--mesh]
        [--iterations N] [--no-validate] [--sweep-nproma N1,N2,...]
        [--profile DIR] [--debug-nans] [--write-input PATH]
        [--write-reference PATH]
    torchrun --nproc-per-node 2 -m cloudsc_tpu_torch 1 163840 128
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dwarf-cloudsc-tpu-torch",
        description="CLOUDSC dwarf on PyTorch + a hand-written CUDA kernel",
    )
    p.add_argument("numomp", type=int, nargs="?", default=1,
                   help="thread count (reference-CLI parity; unused)")
    p.add_argument("ngptot", type=int, nargs="?", default=100,
                   help="total number of grid-point columns (over all ranks)")
    p.add_argument("nproma", type=int, nargs="?", default=128,
                   help="column blocking factor (the scan engine's "
                        "padding granularity)")
    p.add_argument("--precision", choices=("fp32", "fp64"), default=None,
                   help="working precision (default fp32 on cuda, fp64 on cpu)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs on the card; cpu on the host (tests "
                        "and small sizes only)")
    p.add_argument("--input", default=None,
                   help="input snapshot: .npz, .h5 or a Serialbox directory")
    p.add_argument("--reference", default=None,
                   help="golden outputs for validation (.npz or .h5)")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--mesh", action="store_true",
                   help="shard the columns over every visible card in this "
                        "process (refused under several ranks, where each "
                        "rank takes one card)")
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--kernel", choices=("auto", "cuda", "scan"),
                   default="auto",
                   help="compute engine: the fused CUDA kernel (auto, cuda; "
                        "auto runs its plain PyTorch version on --device "
                        "cpu) or the eager scan engine")
    p.add_argument("--iwarmrain", type=int, choices=(1, 2), default=2,
                   help="warm rain: 1 Sundqvist / 2 Khairoutdinov-Kogan "
                        "(ref default 2; ref: cloudsc.F90:562-580)")
    p.add_argument("--ievaprain", type=int, choices=(1, 2), default=2,
                   help="rain evaporation: 1 Sundqvist / 2 Abel-Boutle")
    p.add_argument("--ievapsnow", type=int, choices=(1, 2), default=1,
                   help="snow sublimation: 1 Sundqvist / 2 PSD-based")
    p.add_argument("--idepice", type=int, choices=(1, 2), default=1,
                   help="ice deposition: 1 Rotstayn / 2 ice-PSD-based")
    p.add_argument("--sweep-nproma", default=None, metavar="N1,N2,...",
                   help="several NPROMA values in one process, sharing the "
                        "loaded input: a config line and a perf table a "
                        "value, validation on the last (the prototype1 "
                        "multi-config sweep, ref: src/prototype1/cloudsc/"
                        "cloudsc_driver.F90:10-715)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the timed "
                        "loop into DIR, one file a rank and NPROMA")
    p.add_argument("--debug-nans", action="store_true",
                   help="after every step, check the 21 outputs for a NaN "
                        "or an infinity on the device (outside the timed "
                        "window) and raise FloatingPointError naming the "
                        "field and the step")
    p.add_argument("--write-input", default=None, metavar="PATH",
                   help="write the (unexpanded) input state to PATH, .npz "
                        "or .h5 (also via CLOUDSC_WRITE_INPUT)")
    p.add_argument("--write-reference", default=None, metavar="PATH",
                   help="write the outputs as a reference to PATH, .npz or "
                        ".h5 (also via CLOUDSC_WRITE_REFERENCE)")
    return p


def rank_path(path, rank: int, nranks: int) -> str:
    """PATH for one rank of `nranks`: `.rank<r>` before the suffix when
    there are several ranks (each writes its own file)."""
    if nranks == 1:
        return str(path)
    p = Path(path)
    return str(p.with_name(f"{p.stem}.rank{rank}{p.suffix}"))


def _sweep(parser, args) -> list[int]:
    if not args.sweep_nproma:
        return [args.nproma]
    try:
        sweep = [int(s) for s in args.sweep_nproma.split(",")]
    except ValueError:
        parser.error(f"--sweep-nproma must be comma-separated integers "
                     f"(got {args.sweep_nproma!r})")
    if not sweep or any(n < 1 for n in sweep):
        parser.error("--sweep-nproma values must be >= 1")
    return sweep


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name in ("numomp", "ngptot", "nproma", "iterations"):
        if getattr(args, name) < 1:
            parser.error(f"{name} must be >= 1 (got {getattr(args, name)})")
    sweep = _sweep(parser, args)
    if args.mesh and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        parser.error("--mesh runs every visible card in one process; under "
                     "several ranks each rank takes one card (drop --mesh, "
                     "or run one process)")
    if args.mesh and args.device != "cuda":
        parser.error("--mesh shards over the visible cards and needs "
                     "--device cuda")

    import torch

    from .runtime import dist

    # join the ranks (the CLOUDSC_MPI_INIT analogue) before any device
    # query; a no-op unless WORLD_SIZE > 1 (ref: dwarf_cloudsc.F90:69)
    dist.initialize()
    try:
        if args.device == "cuda" and not torch.cuda.is_available():
            parser.error("--device cuda needs a CUDA device, and "
                         "torch.cuda.is_available() is False (use --device "
                         "cpu for the plain PyTorch version)")
        return _run(parser, args, sweep)
    finally:
        dist.finalize()


def _run(parser, args, sweep) -> int:
    import torch

    from . import data
    from .params import Params
    from .physics.scheme import SchemeConfig
    from .runtime import dist
    from .runtime.driver import CloudscDriver
    from .validate import FIELD_ATTR, REF_DATASET, device_field_norms, \
        reference_on_device, validate_from_norms, validate_outputs

    precision = args.precision or ("fp32" if args.device == "cuda" else "fp64")
    dtype = torch.float64 if precision == "fp64" else torch.float32
    rank, nranks = dist.rank(), dist.world_size()
    rank0 = rank == 0
    device = dist.rank_device(args.device)

    # NGPTOT is the global column count; each rank takes the reference's
    # share and its slice of the file (ref: dwarf_cloudsc.F90:74-77)
    ngptotg = args.ngptot
    try:
        ngptot = dist.rank_share(ngptotg, rank, nranks)
    except ValueError as e:
        parser.error(str(e))
    input_path = args.input or data.default_input_path()
    inp = data.load_input(input_path, ngptot, ngptotg, rank, nranks)
    params = Params.from_input(inp)
    cfg = SchemeConfig(args.iwarmrain, args.ievaprain, args.ievapsnow,
                       args.idepice)
    write_input = args.write_input or os.environ.get("CLOUDSC_WRITE_INPUT")
    write_ref = args.write_reference or os.environ.get(
        "CLOUDSC_WRITE_REFERENCE")
    # the outputs come to the host on the CPU and where a reference is to
    # be written; on the card they stay there (cloudsc_tpu/cli.py:155)
    on_card = device.type == "cuda"
    fetch = bool(write_ref) or not on_card

    for nproma in sweep:
        try:
            driver = CloudscDriver(params, inp.ptsphy, dtype=dtype,
                                   device=device, scheme_config=cfg,
                                   backend=args.kernel, nproma=nproma,
                                   mesh=args.mesh)
        except ValueError as e:
            parser.error(str(e))
        ngpblks = -(-ngptot // nproma)
        if rank0:  # the reference's rank-0-gated config line
            # (ref: cloudsc_driver_mod.F90:121-124)
            print(f"     NUMPROC={max(driver.ndevices, nranks)}, "
                  f"NUMOMP={args.numomp}, NGPTOTG={ngptotg}, "
                  f"NPROMA={nproma}, NGPBLKS={ngpblks}", flush=True)
        trace = None
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            trace = profile(activities=acts)
        if on_card:  # the peak line below reads the last run alone
            for d in driver.devices:
                torch.cuda.reset_peak_memory_stats(d)
        out, timings, timer = driver.run(inp, iterations=args.iterations,
                                         fetch_outputs=fetch, trace=trace,
                                         debug_nans=args.debug_nans)
        if trace is not None:
            os.makedirs(args.profile, exist_ok=True)
            path = os.path.join(args.profile,
                                f"trace_rank{rank}_nproma{nproma}.json")
            trace.export_chrome_trace(path)
            print(f" profiler trace -> {path}")

        # the cross-rank perf gather (ref: timer_mod.F90:167): a collective,
        # so every rank takes part; rank 0 prints
        rank_rows = None
        if nranks > 1:
            rank_rows = dist.gather_perf_rows(
                timings.compute_s * args.iterations,
                ngptot * args.iterations)
        if rank0:
            timer.print_performance(nproma, ngpblks, ngptot,
                                    numomp=args.numomp, rank=rank,
                                    rank_rows=rank_rows,
                                    iterations=args.iterations)
            print(
                f" device compute: {timings.compute_s * 1e3:9.3f} ms | h2d:"
                f" {timings.h2d_s * 1e3:9.3f} ms | d2h:"
                f" {timings.d2h_s * 1e3:9.3f} ms | compile:"
                f" {timings.compile_s:7.3f} s")
            if timings.energy_line:  # EC_PMON (ref: cloudsc_driver_mod.F90:
                print(timings.energy_line)  # 170-178)

    if not args.no_validate:
        ref_path = args.reference or data.default_reference_path()
        multi = nranks > 1
        if fetch:
            validate_outputs(out, data.load_reference(
                ref_path, ngptot, ngptotg, rank, nranks), ngptotg=ngptotg,
                multiprocess=multi)
        else:
            refs = [reference_on_device(ref_path, ngptot, dev, ngptotg,
                                        rank, nranks, columns=cols)
                    for dev, cols in driver.out_shares]
            outs = out if driver.ndevices > 1 else [out]
            norms = device_field_norms(outs, refs).cpu().numpy()
            validate_from_norms(norms, ngptotg, multiprocess=multi,
                                work_eps=float(torch.finfo(dtype).eps))
    if on_card and rank0:
        peak = max(torch.cuda.max_memory_allocated(d) for d in driver.devices)
        print(f" peak device memory: {peak / 2**20:.1f} MiB "
              f"(torch.cuda.max_memory_allocated: the run and its "
              f"validation)")

    # snapshot hooks for regenerating goldens, the reference's Serialbox
    # write hooks (ref: src/prototype1/support/serialize_mod.F90:62-130)
    if write_input:
        path = rank_path(write_input, rank, nranks)
        width = inp.fields["PT"].shape[-1]
        data.write_snapshot(path, inp.fields, {**inp.scalars, "KLON": width})
        print(f" wrote input snapshot -> {path}")
    if write_ref:
        path = rank_path(write_ref, rank, nranks)
        width = min(inp.klon_file, ngptot)
        snap = {REF_DATASET[name]: getattr(out, attr)[..., :width]
                for name, attr in FIELD_ATTR.items()}
        data.write_snapshot(path, snap, {
            "KLON": width, "KLEV": inp.klev,
            "KFLDX": inp.scalars.get("KFLDX", 0)})
        print(f" wrote reference snapshot -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
