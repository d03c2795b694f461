"""dwarf-cloudsc-tpu-torch command line entry point.

CLI-compatible with every reference variant: `prog NUMOMP NGPTOT NPROMA`
(ref: src/cloudsc_fortran/dwarf_cloudsc.F90:48-83). NUMOMP has no meaning on
one GPU (accepted for parity), NGPTOT is the total column count and NPROMA
the scan engine's column-padding granularity (the kernel takes any column
count). Prints the reference's
config line, throughput table and validation table, in the format of
`python -m cloudsc_tpu`.

`--kernel` picks the engine (`runtime.driver.CloudscDriver`'s backend): the
fused CUDA kernel (auto, cuda; with `--device cpu` auto runs its plain
PyTorch version) or the eager scan engine (scan). The four scheme flags
select the SchemeConfig version, with the JAX CLI's choices and defaults.
On the card the outputs stay there and are validated there (the norms of
`validate.device_field_norms` against the reference expanded on the card);
only the (21, 5) norms reach the host. With `--device cpu` the host
validates the fetched fields.
With EC_PMON set in the environment the energy line of `runtime.pmon` (the
card's, from NVML) follows the timing line.

Usage:
    python -m cloudsc_tpu_torch 1 163840 128 [--precision fp32|fp64]
        [--device cuda|cpu] [--kernel auto|cuda|scan] [--iwarmrain 1|2]
        [--ievaprain 1|2] [--ievapsnow 1|2] [--idepice 1|2]
        [--iterations N] [--no-validate]
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dwarf-cloudsc-tpu-torch",
        description="CLOUDSC dwarf on PyTorch + a hand-written CUDA kernel",
    )
    p.add_argument("numomp", type=int, nargs="?", default=1,
                   help="thread count (reference-CLI parity; unused)")
    p.add_argument("ngptot", type=int, nargs="?", default=100,
                   help="total number of grid-point columns")
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
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name in ("numomp", "ngptot", "nproma", "iterations"):
        if getattr(args, name) < 1:
            parser.error(f"{name} must be >= 1 (got {getattr(args, name)})")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda needs a CUDA device, and "
                     "torch.cuda.is_available() is False (use --device cpu "
                     "for the plain PyTorch version)")
    precision = args.precision or ("fp32" if args.device == "cuda" else "fp64")
    dtype = torch.float64 if precision == "fp64" else torch.float32

    from . import data
    from .params import Params
    from .physics.scheme import SchemeConfig
    from .runtime.driver import CloudscDriver
    from .validate import device_field_norms, reference_on_device, \
        validate_from_norms, validate_outputs

    ngptot, nproma = args.ngptot, args.nproma
    inp = data.load_input(args.input or data.default_input_path(), ngptot)
    params = Params.from_input(inp)
    cfg = SchemeConfig(args.iwarmrain, args.ievaprain, args.ievapsnow,
                       args.idepice)
    try:
        driver = CloudscDriver(params, inp.ptsphy, dtype=dtype,
                               device=args.device, scheme_config=cfg,
                               backend=args.kernel, nproma=nproma)
    except ValueError as e:
        parser.error(str(e))
    on_card = args.device == "cuda"
    ngpblks = -(-ngptot // nproma)
    # the reference's config line (ref: cloudsc_driver_mod.F90:121-124)
    print(f"     NUMPROC=1, NUMOMP={args.numomp}, NGPTOTG={ngptot}, "
          f"NPROMA={nproma}, NGPBLKS={ngpblks}")
    out, timings, timer = driver.run(inp, iterations=args.iterations,
                                     fetch_outputs=not on_card)
    timer.print_performance(nproma, ngpblks, ngptot, numomp=args.numomp,
                            iterations=args.iterations)
    print(
        f" device compute: {timings.compute_s * 1e3:9.3f} ms | h2d:"
        f" {timings.h2d_s * 1e3:9.3f} ms | d2h: {timings.d2h_s * 1e3:9.3f} ms |"
        f" compile: {timings.compile_s:7.3f} s"
    )
    if timings.energy_line:  # EC_PMON (ref: cloudsc_driver_mod.F90:170-178)
        print(timings.energy_line)
    if not args.no_validate:
        ref_path = args.reference or data.default_reference_path()
        if on_card:
            norms = device_field_norms(
                out, reference_on_device(ref_path, ngptot, driver.device))
            validate_from_norms(norms.cpu().numpy(), ngptot,
                                work_eps=float(torch.finfo(dtype).eps))
        else:
            validate_outputs(out, data.load_reference(ref_path, ngptot),
                             ngptotg=ngptot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
