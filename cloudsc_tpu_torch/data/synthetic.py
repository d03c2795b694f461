"""Synthetic states that drive the scheme's alternate branches.

The 100-column snapshot produces no rain flux (all precipitation is snow),
so the rain-evaporation switch cannot change its outputs, and its aerosol
fields are zero (the couplings are off in the reference configuration), so
`rnice / pnice` would divide by zero. These copies of an `InputData` fix
both, as the JAX package's tests do (tests/test_scheme_versions.py
`_raining_fields` and the aerosol values of
`test_aerosol_couplings_pallas_matches_scan`), but at file width, before
the pack or the field dict expands them.

`VERSION_CASES` names the scheme versions that are checked against each
other beyond the reference configuration: the four single alternates and
the aerosol build, each with the input that takes its branch.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from ..physics.scheme import SchemeConfig

# physically plausible aerosol values (CCN cm-3, IN m-3, effective ice
# radius m, critical liquid / ice water)
AEROSOL_VALUES = {"PCCN": 125.0, "PNICE": 1.0e4, "PRE_ICE": 50.0e-6,
                  "PLCRIT_AER": 5.0e-4, "PICRIT_AER": 2.0e-4}
AEROSOL_FLAGS = ("laericesed", "laericeauto", "laerliqautolsp", "laerliqcoll")
# rain water from this share of the depth down to the surface
RAIN_DEPTH, RAIN_WATER = 0.6, 2.0e-4

# name -> (SchemeConfig switches, input): "snapshot", "raining" or "aerosol"
VERSION_CASES = {
    "iwarmrain1": ((1, 2, 1, 1), "snapshot"),
    "ievaprain1": ((2, 1, 1, 1), "raining"),
    "ievapsnow2": ((2, 2, 2, 1), "snapshot"),
    "idepice2": ((2, 2, 1, 2), "snapshot"),
    "aerosol": ((1, 2, 1, 1), "aerosol"),
}


def raining(inp):
    """A copy of `inp` with rain water RAIN_WATER in PCLV's rain slot from
    RAIN_DEPTH of the levels down, so sedimentation builds a rain flux
    that evaporates below."""
    pclv = np.array(inp.fields["PCLV"], copy=True)
    pclv[2, int(pclv.shape[1] * RAIN_DEPTH):, :] = RAIN_WATER
    return dataclasses.replace(inp, fields={**inp.fields, "PCLV": pclv})


def aerosol(inp, params):
    """(a copy of `inp` with the AEROSOL_VALUES fields, a copy of `params`
    with every aerosol coupling on)."""
    shape = np.asarray(inp.fields["PT"]).shape
    fields = {**inp.fields, **{k: np.full(shape, v, np.float64)
                               for k, v in AEROSOL_VALUES.items()}}
    params = copy.deepcopy(params)
    for flag in AEROSOL_FLAGS:
        setattr(params.ydecldp, flag, True)
    return dataclasses.replace(inp, fields=fields), params


def version_case(name, inp, params):
    """(input, params, SchemeConfig) of VERSION_CASES[name]."""
    switches, kind = VERSION_CASES[name]
    if kind == "raining":
        inp = raining(inp)
    elif kind == "aerosol":
        inp, params = aerosol(inp, params)
    return inp, params, SchemeConfig(*switches)
