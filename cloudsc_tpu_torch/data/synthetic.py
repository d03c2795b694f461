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
`FORM_CASES` names K1's form builds that are held to their plain version:
the seven other (fc, fn, fd) packs, the unfolded pack, the four derivable
flux rows written by the kernel on the folded and on the unfolded pack,
two skip sets that between them drop all 16 sections (the second with the
per-round 5.2.1 skip) and the build without dynamic skips; between them
every macro branch of the scheme header and the kernel.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from ..physics.scheme import SKIP_TAGS, SchemeConfig

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

# skip set A, and B = the other eight tags
SKIP_A = frozenset({"s31", "s34e", "s37", "s43b", "s44a", "s44c", "s45s",
                    "s521"})
SKIP_B = frozenset(SKIP_TAGS) - SKIP_A
# name -> (the build's form keywords {fold_inputs, fc, fn, fd, fold_outputs},
# each absent at its default, SchemeConfig keywords)
FORM_CASES = {
    "fn_off": (dict(fn=False), {}),
    "fn_fd": (dict(fd=True), {}),
    "fc_fn": (dict(fc=True), {}),
    "fc_fn_fd": (dict(fc=True, fd=True), {}),
    "fd_inline": (dict(fn=False, fd=True), {}),
    "fc_inline": (dict(fc=True, fn=False), {}),
    "fc_fd_inline": (dict(fc=True, fn=False, fd=True), {}),
    "unfolded": (dict(fold_inputs=False, fn=False), {}),
    "foldo_off": (dict(fold_outputs=False), {}),
    "unfolded_foldo_off": (dict(fold_inputs=False, fn=False,
                                fold_outputs=False), {}),
    "skip_a": ({}, dict(skip=SKIP_A)),
    "skip_b_round": ({}, dict(skip=SKIP_B, s521_round_skip=True)),
    "no_dynamic_skips": ({}, dict(dynamic_skips=False)),
}


def split_form(form: dict) -> tuple[dict, bool]:
    """A FORM_CASES form -> (the pack's form keywords, for
    `cuda_cloudsc.pack_inputs_raw`; fold_outputs)."""
    form = dict(form)
    return form, form.pop("fold_outputs", True)


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
