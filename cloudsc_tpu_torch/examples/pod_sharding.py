"""CLOUDSC with its columns sharded over several devices of one process.

Counterpart of the JAX package's `examples/pod_sharding.py`. Columns are
independent, so a mesh is a pure column decomposition with no collective
in the compute, as the reference's MPI decomposition (ref:
dwarf_cloudsc.F90:74-77): the driver cuts the columns into contiguous
shares, one a device, and launches the kernel once a device. Only the
validation norms reduce: each device reduces its own share against the
reference's share on that device, and the host reduces the (21, 5) rows;
no field leaves its device.

    python -m cloudsc_tpu_torch.examples.pod_sharding            # every card
    python -m cloudsc_tpu_torch.examples.pod_sharding --devices cpu,cpu

A device may repeat (`--devices cuda:0,cuda:0` runs a mesh of two shares
on one card). Several hosts or processes run the CLI under `torchrun`
instead (`python -m cloudsc_tpu_torch --help`).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cloudsc_tpu_torch.examples.pod_sharding",
        description="CLOUDSC column-sharded over a device mesh")
    p.add_argument("--devices", default=None,
                   help="comma-separated devices (default: every visible "
                        "card; cpu,cpu runs on the host)")
    p.add_argument("--ngptot", type=int, default=None,
                   help="columns (default 1024 a device)")
    p.add_argument("--precision", choices=("fp32", "fp64"), default="fp32")
    p.add_argument("--iterations", type=int, default=2)
    args = p.parse_args(argv)

    import torch

    from .. import data
    from ..params import Params
    from ..runtime import dist
    from ..runtime.driver import CloudscDriver
    from ..validate import device_field_norms, reference_on_device, \
        validate_from_norms

    devices = dist.column_devices(
        args.devices.split(",") if args.devices else None)
    ngptot = args.ngptot or 1024 * len(devices)
    dtype = torch.float64 if args.precision == "fp64" else torch.float32
    print(f"{len(devices)} devices ({', '.join(map(str, devices))}), "
          f"{ngptot} columns, {args.precision}")

    inp = data.load_input(data.default_input_path(), ngptot)
    params = Params.from_input(inp)
    driver = CloudscDriver(params, inp.ptsphy, dtype=dtype, nproma=128,
                           devices=devices)
    outs, timings, _ = driver.run(inp, iterations=args.iterations,
                                  fetch_outputs=False)
    if driver.ndevices == 1:
        outs = [outs]
    print(f"compute {timings.compute_s * 1e3:.3f} ms a step over the mesh "
          f"(warm-up {timings.compile_s:.3f} s)")

    # validate without gathering fields: each device reduces its share
    ref_path = data.default_reference_path()
    refs = [reference_on_device(ref_path, ngptot, dev, columns=cols)
            for dev, cols in driver.out_shares]
    norms = device_field_norms(outs, refs).numpy()
    # flag against the run's working precision, like the reference's
    # single-precision build (ref: validate_mod.F90:270)
    validate_from_norms(norms, ngptot, work_eps=float(torch.finfo(dtype).eps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
