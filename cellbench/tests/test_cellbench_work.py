"""The work count depends on columns, levels and precision alone: the same
whether the program streams the folded pack, the unfolded pack or the
field dict, and the field dict the resident traffic hands the step holds
at least the bytes counted as read."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cellbench import inputs, work

NCOL = 64


def _snapshot_input(ncol):
    from cloudsc_tpu_torch import data

    return data.load_input(str(inputs.SNAPSHOT), ncol)


def _shape(x):
    """(ncol, nlev, precision) of a pack or a field dict."""
    from cloudsc_tpu_torch.kernels.cuda_cloudsc import FoldedPack

    if isinstance(x, FoldedPack):
        t, nlev, ncol = x.pack, x.nlev, x.ncol
    else:
        t = x["pt"]
        nlev, ncol = t.shape
    return ncol, nlev, {torch.float32: "fp32", torch.float64: "fp64"}[t.dtype]


@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_count_is_the_same_for_every_form(precision):
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.params import Params
    from cloudsc_tpu_torch.physics.cloudsc import make_inputs

    inp = _snapshot_input(NCOL)
    params = Params.from_input(inp)
    dtype = inputs.DTYPES[precision]
    folded = cc.pack_inputs_folded(inp, params, None, dtype)
    unfolded = cc.pack_inputs_unfolded(inp, params, None, dtype)
    fields = make_inputs(inp, dtype)
    shapes = {_shape(x) for x in (folded, unfolded, fields)}
    assert shapes == {(NCOL, 137, precision)}
    counts = {(work.step_bytes(*s), work.step_flops(*s[:2])) for s in shapes}
    assert len(counts) == 1
    # the port's own model counts the form it streams: it differs
    assert cc.k1_bytes(folded) != cc.k1_bytes(unfolded)


@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_resident_dict_holds_the_counted_inputs(precision):
    fields, scalars = inputs.load_snapshot()
    d = inputs.field_dict(fields, NCOL, precision, "cpu")
    held = sum(t.numel() * t.element_size() for t in d.values())
    assert held >= work.input_bytes(NCOL, 137, precision)
    # every counted input is in the dict under its own name
    keys = {n.split("[")[0].lower() for n, kind, _ in
            work.field_table(137, precision) if kind == "in"}
    assert keys <= set(d)


def test_count_at_the_jube_size():
    # 163,840 fp64 columns: 9.18 GB a step, 2.74 ms at 3.35 TB/s against
    # 0.60 ms of operations at 34 TFLOP/s
    b = work.step_bytes(163840, 137, "fp64")
    assert b == 163840 * ((26 * 137 + 138 + 1) * 8 + 2 * 4
                          + (10 * 137 + 14 * 138 + 1) * 8)
    t, bound = work.least_time_s(163840, 137, "fp64")
    assert bound == "bytes" and 2.7e-3 < t < 2.8e-3
    assert np.isclose(work.step_flops(163840, 137), 163840 * 124823.29)
    assert work.step_bytes(163840, 137, "fp32") < b
    assert work.least_time_s(163840, 137, "fp32")[1] == "bytes"
