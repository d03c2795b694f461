"""Multi-step integration: CLOUDSC driven in a production-style timestep loop.

The dwarf benchmarks ONE physics step (ref: cloudsc_driver_mod.F90 calls
CLOUDSC once per block and validates); in the IFS the scheme runs every
timestep with the prognostic state advanced by its own tendencies. This
example closes that loop on the device: the state and the per-step
diagnostics stay there from the first step to the last, and nothing is
copied to the host between steps.

State advanced each step (what the IFS time-stepping applies):

    T      += dt * tendency_loc_t
    q      += dt * tendency_loc_q
    a      += dt * tendency_loc_a     (clipped to [0, 1])
    cld[m] += dt * tendency_loc_cld[m]

Everything else (dynamical/radiative/convective forcings, VDF fluxes,
supersaturation source) is held fixed — a "frozen large-scale forcing"
single-column experiment. The cumulative-tendency inputs TENDENCY_TMP are
zeroed after the first step: their step-1 values are the other IFS physics'
contributions baked into the snapshot, which CLOUDSC folds into its initial
state (ref: cloudsc.F90:662-682); repeating them every step would
double-apply that forcing.

    python -m cloudsc_tpu_torch.examples.timestep_loop [--device cpu]

Prints the domain-mean surface precipitation and column water path per step,
plus a water-budget residual: the step's total moisture change against the
precipitation leaving through the surface (sedimentation flux divergence is
the only path out of the column).
"""

from __future__ import annotations

import sys

NSTEPS = 24

STATE_KEYS = ("pt", "pq", "pa", "pclv", "tendency_tmp_t", "tendency_tmp_q",
              "tendency_tmp_a", "tendency_tmp_cld", "psupsat")


def column_weight(fields, params):
    """dp/g column-integral weight per level: kg water / m^2 per (kg/kg)."""
    return (fields["paph"][1:] - fields["paph"][:-1]) / params.ydcst.rg


def make_step(fields, params, dt):
    """The loop body advancing (T, q, a, cld) by CLOUDSC's own tendencies:
    `step(state) -> (next state, diagnostics)`, all on the fields' device."""
    import torch

    from ..physics.cloudsc import cloudsc

    dpog = column_weight(fields, params)

    def step(state):
        f = dict(fields)
        f.update(state)
        out = cloudsc(f, params, dt, None)
        nxt = {
            "pt": f["pt"] + dt * out.tendency_loc_t,
            "pq": f["pq"] + dt * out.tendency_loc_q,
            "pa": torch.clamp(f["pa"] + dt * out.tendency_loc_a, 0.0, 1.0),
            "pclv": f["pclv"] + dt * out.tendency_loc_cld,
            # the snapshot's accumulated other-physics tendencies apply once
            "tendency_tmp_t": torch.zeros_like(f["tendency_tmp_t"]),
            "tendency_tmp_q": torch.zeros_like(f["tendency_tmp_q"]),
            "tendency_tmp_a": torch.zeros_like(f["tendency_tmp_a"]),
            "tendency_tmp_cld": torch.zeros_like(f["tendency_tmp_cld"]),
            "psupsat": torch.zeros_like(f["psupsat"]),
        }
        # diagnostics: domain-mean surface precip (kg/m^2/s) and the total
        # condensate+vapour path of the advanced state (kg/m^2)
        sprecip = (out.pfplsl[-1] + out.pfplsn[-1]).mean()
        qtot = nxt["pq"] + nxt["pclv"][:4].sum(dim=0)
        wpath = (dpog * qtot).sum(dim=0).mean()
        return nxt, dict(sprecip=sprecip, wpath=wpath)

    return step


def integrate(step, state, nsteps: int):
    """`nsteps` of `step` from `state`: (final state, diagnostics stacked
    per step), everything left on the device."""
    import torch

    diags = []
    with torch.no_grad():
        for _ in range(nsteps):
            state, diag = step(state)
            diags.append(diag)
    return state, {k: torch.stack([d[k] for d in diags]) for k in diags[0]}


def water_path(fields, params, state):
    """Domain-mean condensate+vapour path of `state` (kg/m^2), 0-d."""
    qtot = state["pq"] + state["pclv"][:4].sum(dim=0)
    return (column_weight(fields, params) * qtot).sum(dim=0).mean()


def main(argv=None) -> int:
    import numpy as np

    from . import example_parser, load_fields

    parser = example_parser("timestep_loop", __doc__.splitlines()[0])
    parser.add_argument("--nsteps", type=int, default=NSTEPS)
    args = parser.parse_args(argv)
    inp, params, fields = load_fields(args.ngptot, args.device)
    dt, nsteps = inp.ptsphy, args.nsteps
    state0 = {k: fields[k] for k in STATE_KEYS}
    final, diags = integrate(make_step(fields, params, dt), state0, nsteps)
    sprecip = diags["sprecip"].cpu().numpy()
    wpath = diags["wpath"].cpu().numpy()
    q0 = float(water_path(fields, params, state0))

    print(f"{nsteps} steps x dt={dt:.0f} s, {args.ngptot} columns, fp64 "
          f"eager engine on {fields['pt'].device}")
    print(f"{'step':>4} {'surf precip mm/day':>19} {'water path kg/m2':>17}")
    for i in range(nsteps):
        print(f"{i + 1:>4} {86400.0 * sprecip[i]:>19.4f} {wpath[i]:>17.6f}")

    # budget: water-path change over the run vs cumulative surface precip.
    # CLOUDSC's only external water SOURCE acting on the advanced state is
    # convective detrainment (PLUDE/PSNDE enter ZSOLQA diagonals,
    # ref: cloudsc.F90:1090-1127); the VDF/dynamics "tendencies" are frozen
    # forcings of the saturation budget, never applied to q directly. So
    #   change + surface precip ≈ detrainment put in each step,
    # and the (small) remainder is the supersat source and clipping terms.
    lost = float(dt * sprecip.sum())
    change = float(wpath[-1] - q0)
    src = change + lost
    print(f"\nwater budget over {nsteps} steps (domain mean, kg/m2):")
    print(f"  path change        {change:+.6e}")
    print(f"  precip to surface  {lost:+.6e}")
    print(f"  implied in-column source (detrainment + supersat) {src:+.3e}")
    if not src > -1e-9:
        raise RuntimeError("scheme destroyed water beyond roundoff")
    if not (np.isfinite(sprecip).all() and np.isfinite(wpath).all()):
        raise RuntimeError("non-finite diagnostics")
    return 0


if __name__ == "__main__":
    sys.exit(main())
