"""Adjoint sensitivity of surface precipitation to the temperature profile.

The question a forecaster or data-assimilation system asks: *which levels'
temperature does this column's surface precipitation actually depend on?*
The IFS answers it with hand-written tangent-linear/adjoint physics; here it
is one `autodiff.grad` through the eager engine (tests/test_torch_grad.py
holds the correctness pins).

    python -m cloudsc_tpu_torch.examples.adjoint_sensitivity [--device cpu]

Prints, for a few snapshot columns, the five levels whose temperature most
strongly controls total surface precipitation (rain+snow flux through the
lowest half-level), with the sign of the sensitivity.
"""

from __future__ import annotations

import sys

COLUMNS = (0, 17, 42, 83)


def surface_precip(out, cols):
    """Rain + snow flux through the lowest half-level, summed over columns
    (summing makes d/dT(k, col) the per-column sensitivity, since columns
    are independent)."""
    return (out.pfplsl[-1] + out.pfplsn[-1]).sum()


def sensitivity(ngptot: int = 100, device="cuda"):
    """d(surface precip)/dT as a (nlev, ncol) numpy array
    [kg m-2 s-1 / K]."""
    from ..physics import autodiff
    from . import load_fields

    inp, params, fields = load_fields(ngptot, device)
    g = autodiff.grad(surface_precip, fields, params, inp.ptsphy, ("pt",),
                      device=device)["pt"]
    return g.cpu().numpy()


def main(argv=None) -> int:
    import numpy as np

    from . import example_parser

    args = example_parser("adjoint_sensitivity", __doc__.splitlines()[0]
                          ).parse_args(argv)
    g = sensitivity(args.ngptot, args.device)
    print("adjoint sensitivity d(surface precip)/d(T level)  [kg m-2 s-1 / K]")
    for col in (c for c in COLUMNS if c < g.shape[1]):
        top = np.argsort(-np.abs(g[:, col]))[:5]
        terms = ", ".join(
            f"L{int(k):d}:{g[k, col]:+.2e}" for k in sorted(top)
        )
        print(f"  column {col:3d}: {terms}")
    print(f"  nonzero sensitivities: {(g != 0).sum()} of {g.size} "
          f"(zeros above cloud top / inactive branches)")
    if not np.isfinite(g).all():
        raise RuntimeError("NaN/inf in the adjoint")
    return 0


if __name__ == "__main__":
    sys.exit(main())
