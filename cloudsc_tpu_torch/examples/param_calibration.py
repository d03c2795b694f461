"""Gradient-based physics-parameter calibration and sensitivity.

The IFS tunes cloud-scheme parameters (erosion rates, RHcrit, autoconversion
thresholds — the TECLDP scalars, ref: src/common/module/yoecldp.F90:94-235)
by hand against observations; the dwarf ships no tangent-linear/adjoint code
for them. Here the whole scheme is differentiable, so a parameter Jacobian is
one `autodiff.grad` through the eager engine.

    python -m cloudsc_tpu_torch.examples.param_calibration [--device cpu]

Three demos on the snapshot:
  1. a sensitivity table dJ/dlog(theta) for a handful of TECLDP parameters,
     where J is the mean-square T tendency (which parameters matter at all);
  2. recovery of a hidden RCLDIFF (turbulent erosion rate, section 3.4 of
     the scheme) from tendency "observations": start from a 2x-perturbed
     value and descend dJ/dtheta back to the truth;
  3. a perturbed-parameter ensemble in one run: the members stacked along
     the column axis with the parameter as one value a column (columns are
     independent, so each member equals its single run bit for bit).

A parameter enters the scheme as a plain scalar, so differentiating one is
naming it: `autodiff` puts a tensor in place of the float.
"""

from __future__ import annotations

import sys

# TECLDP scalars that enter the scheme arithmetically (not as Python
# branches), so a tensor in their place flows straight through autograd
TUNABLE = ("rcldiff", "ramid", "rkooptau", "rtaumel", "rcovpmin")
MEMBERS = 9
STEPS = 12


def mean_square_t(n: int):
    """J = mean(tendency_T^2) over `n` values, as a sum over columns."""
    def head(out, cols):
        return (out.tendency_loc_t ** 2).sum() / n
    return head


def misfit_head(obs, n: int):
    """The misfit to the observed T and q tendencies (full-width tensors),
    as a sum over the block's columns."""
    def head(out, cols):
        return (((out.tendency_loc_t - obs.tendency_loc_t[:, cols]) ** 2
                 ).sum()
                + 1e6 * ((out.tendency_loc_q - obs.tendency_loc_q[:, cols])
                         ** 2).sum()) / n
    return head


def stacked_ensemble(fields: dict, params, name: str, thetas):
    """The ensemble as one run: the field dict repeated once a member along
    the column axis, and `name` as a `(members * ncol,)` tensor holding each
    member's value on its columns. Returns (fields, params)."""
    import torch

    from ..physics.autodiff import with_params

    ncol = fields["pt"].shape[-1]
    wide = {k: torch.cat([v] * len(thetas), dim=-1) for k, v in fields.items()}
    theta = torch.as_tensor(thetas, dtype=fields["pt"].dtype,
                            device=fields["pt"].device)
    return wide, with_params(params, {name: theta.repeat_interleave(ncol)})


def main(argv=None) -> int:
    import numpy as np
    import torch

    from ..physics import autodiff
    from ..physics.cloudsc import cloudsc
    from . import example_parser, load_fields

    args = example_parser("param_calibration", __doc__.splitlines()[0]
                          ).parse_args(argv)
    inp, params, fields = load_fields(args.ngptot, args.device)
    dt, kw = inp.ptsphy, dict(device=args.device)
    n = fields["pt"].numel()

    # --- 1. which parameters does the T tendency care about? -------------
    print("sensitivity of J = mean(tendency_T^2) to TECLDP parameters")
    print(f"  {'param':<10} {'value':>12} {'dJ/dlog(theta)':>16}")
    grads = autodiff.grad(mean_square_t(n), fields, params, dt, TUNABLE, **kw)
    for name in TUNABLE:
        theta0 = getattr(params.ydecldp, name)
        print(f"  {name:<10} {theta0:>12.4e} "
              f"{float(grads[name]) * theta0:>16.3e}")
    print("  (exact zeros are honest: that process never binds on this"
          " snapshot,\n   e.g. melting is mass-limited, so d/d rtaumel = 0)")

    # --- 2. recover a hidden RCLDIFF from tendency observations ----------
    true_theta = params.ydecldp.rcldiff
    with torch.no_grad():
        obs = cloudsc(fields, params, dt)
    misfit = misfit_head(obs, n)
    # descend in log-space (the parameter is positive and scale-free)
    log_theta = float(np.log(2.0 * true_theta))
    lr = 0.4
    print(f"\nrecovering RCLDIFF (truth {true_theta:.6e}) from a 2x start")
    for it in range(STEPS):
        theta = float(np.exp(log_theta))
        val, g = autodiff.value_and_grad(
            misfit, fields, autodiff.with_params(params, {"rcldiff": theta}),
            dt, ("rcldiff",), **kw)
        log_theta -= lr * float(np.sign(float(g["rcldiff"]) * theta))
        lr *= 0.62
        print(f"  it {it:2d}: theta {theta:.6e}  J {float(val):.3e}")
    final = float(np.exp(log_theta))
    rel = abs(final - true_theta) / true_theta
    print(f"  recovered {final:.6e}  (rel err {rel:.1e})")
    if not rel < 0.05:
        raise RuntimeError("calibration failed to re-approach the truth")

    # --- 3. perturbed-parameter ensemble in ONE run ----------------------
    # the PPE workflow (run the scheme under N parameter perturbations and
    # look at the output spread): the members side by side on the column
    # axis, the parameter one value a column
    thetas = true_theta * np.geomspace(0.25, 4.0, MEMBERS)
    wide, wparams = stacked_ensemble(fields, params, "rcldiff", thetas)
    ncol = fields["pt"].shape[-1]

    def column_misfit(out, cols):
        src = torch.arange(cols.start, cols.stop,
                           device=out.tendency_loc_t.device) % ncol
        return (((out.tendency_loc_t - obs.tendency_loc_t[:, src]) ** 2
                 ).sum(dim=0)
                + 1e6 * ((out.tendency_loc_q - obs.tendency_loc_q[:, src])
                         ** 2).sum(dim=0)) / n

    ens = autodiff.value(column_misfit, wide, wparams, dt, **kw
                         ).reshape(MEMBERS, ncol).sum(dim=1).cpu().numpy()
    print(f"\nperturbed-parameter ensemble ({MEMBERS} members, one run):")
    for t, v in zip(thetas, ens):
        print(f"  rcldiff {t:.3e} -> tendency misfit {v:.3e}")
    # the center member is rcldiff*(1 +- 1ulp of geomspace), so the misfit
    # is zero up to rounding of the parameter itself
    if not float(ens[MEMBERS // 2]) < 1e-25:
        raise RuntimeError("center member must reproduce the obs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
