"""Worked examples of the differentiable scheme and the timestep loop, the
counterparts of the JAX package's `examples/`:

    python -m cloudsc_tpu_torch.examples.adjoint_sensitivity
    python -m cloudsc_tpu_torch.examples.param_calibration
    python -m cloudsc_tpu_torch.examples.timestep_loop
    python -m cloudsc_tpu_torch.examples.pod_sharding

The first three take `--device cuda|cpu` (the card unless asked otherwise;
it raises without one) and `--ngptot N` (100 columns, the snapshot's, by
default), and run the eager engine in fp64. `pod_sharding` runs the fused
step over a mesh of devices (`--devices`, every visible card by default).
"""

from __future__ import annotations

import argparse


def example_parser(prog: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"python -m cloudsc_tpu_torch.examples."
                                     f"{prog}", description=description)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs on the card; cpu on the host")
    p.add_argument("--ngptot", type=int, default=100,
                   help="number of grid-point columns")
    return p


def load_fields(ngptot: int, device):
    """(InputData, Params, the plain fp64 field dict on `device`)."""
    import torch

    from .. import data
    from ..params import Params
    from ..physics.autodiff import resolve_device
    from ..physics.cloudsc import fields_on_device

    device = resolve_device(device)
    inp = data.load_input(data.default_input_path(), ngptot)
    return inp, Params.from_input(inp), fields_on_device(inp, torch.float64,
                                                         device)
