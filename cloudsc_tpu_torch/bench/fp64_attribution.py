"""Attribute the fp64 `!!!!` validation flags to transcendental ulps.

Counterpart of the JAX package's `bench/fp64_attribution.py`, on the eager
engine. The outputs come from the device's `exp` (libdevice on the card,
the host's vector library on the CPU), not gfortran's, so transcendental
results can differ from the reference's by ulps. The experiment asks how
much of the error against the reference is explained by that alone: rerun
the identical fp64 engine with every `torch.exp` the scheme evaluates
perturbed by exactly one ulp (x * (1 + 2^-52)) and measure, per field, the
errsum/refsum shift of the perturbed run against the unperturbed one.

If shift(1 ulp in exp) >= the error against the reference, the flags are
irreducible transcendental noise, not an op-order bug.

    python -m cloudsc_tpu_torch.bench.fp64_attribution            # the card, 163,840 columns
    python -m cloudsc_tpu_torch.bench.fp64_attribution --device cpu --ngptot 100

Both columns are errsum/refsum as the validation table's MaxRelErr forms it
(`validate.FieldErrors.relerr`: an absolute errsum below eps reads as 0,
which at 100 columns hides most fields; at 163,840 columns it does not).
"""

from __future__ import annotations

import argparse
import sys
from contextlib import contextmanager

ULP = 2.0 ** -52


@contextmanager
def exp_off_by_one_ulp():
    """Every `torch.exp` call returns its result times (1 + 2^-52)."""
    import torch

    orig = torch.exp
    torch.exp = lambda x: orig(x) * (1.0 + ULP)
    try:
        yield
    finally:
        torch.exp = orig


def attribute(ngptot: int, device):
    """[(field, relerr against the reference, relerr of the perturbed run
    against the unperturbed one, flagged against the reference)]."""
    import torch

    from .. import data
    from ..params import Params
    from ..physics.autodiff import resolve_device
    from ..physics.cloudsc import cloudsc, fields_on_device
    from ..validate import FIELD_ATTR, REF_DATASET, VALIDATION_ORDER, \
        device_field_norms, reference_on_device, validate_from_norms

    device = resolve_device(device)
    inp = data.load_input(data.default_input_path(), ngptot)
    params = Params.from_input(inp)
    fields = fields_on_device(inp, torch.float64, device)
    with torch.no_grad():
        base = cloudsc(fields, params, inp.ptsphy)
        with exp_off_by_one_ulp():
            pert = cloudsc(fields, params, inp.ptsphy)
    ref = reference_on_device(data.default_reference_path(), ngptot, device)
    own = {REF_DATASET[name]: getattr(base, FIELD_ATTR[name])
           for name, _ in VALIDATION_ORDER}
    rows = []
    for name, e_ref, e_ulp in zip(
            (n for n, _ in VALIDATION_ORDER),
            validate_from_norms(device_field_norms(base, ref).cpu().numpy(),
                                ngptot, print_table=False),
            validate_from_norms(device_field_norms(pert, own).cpu().numpy(),
                                ngptot, print_table=False)):
        rows.append((name, e_ref.relerr, e_ulp.relerr, e_ref.flagged))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cloudsc_tpu_torch.bench.fp64_attribution",
        description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--ngptot", type=int, default=163840)
    args = p.parse_args(argv)
    rows = attribute(args.ngptot, args.device)
    if args.device == "cuda":
        from .timing import card

        print(card())
    print(f"fp64 eager engine, {args.ngptot} columns, device {args.device}")
    print(f"{'field':<20s} {'vs-ref relerr':>14s} {'1ulp-exp shift':>14s} "
          f"{'explained':>9s} {'flag':>5s}")
    for name, e_ref, e_ulp, flagged in rows:
        tag = "yes" if e_ulp >= e_ref or e_ref == 0.0 else "NO"
        print(f"{name:<20s} {e_ref:14.3e} {e_ulp:14.3e} {tag:>9s} "
              f"{'!!!!' if flagged else '':>5s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
