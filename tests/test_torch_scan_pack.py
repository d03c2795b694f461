"""The scan engine's pre-packed closure on the CPU (`physics.cloudsc.
scan_pack`, CLOUDSC_SCAN_PACKED=1), against the plain dict and the JAX
package.

  * `cloudsc(scan_pack(fields))` is bit for bit `cloudsc(fields)`: eager
    PyTorch runs the same operations on the same values (the JAX engine
    allows one contraction ulp, tests/test_invariance.py, only because XLA
    fuses the two programs differently), for the plain and the folded
    dict, fp32 and fp64, and with every aerosol coupling (the S stack's
    aerosol rows);
  * the stacks' rows are the JAX module's, and the port's pre-packed step
    agrees with the JAX `scan_pack` step within test_golden's FP64_TOL
    (the engines' bar, test_torch_engine.py);
  * folded-curve, Newton and deposition dicts are refused;
  * the driver's CLOUDSC_SCAN_PACKED=1 packs each device's share once and
    gives the plain dict's outputs bit for bit, on one device and on a CPU
    mesh of two.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc_tpu.data import load_input
from cloudsc_tpu.physics import make_inputs as jmake_inputs
from cloudsc_tpu_torch.data import synthetic
from cloudsc_tpu_torch.physics import cloudsc as tcloudsc
from cloudsc_tpu_torch.physics import scheme as tscheme

from conftest import REFERENCE_DATA, relerr
from test_golden import FP64_TOL

torch.set_num_threads(1)
# the JAX engine's module (its package exports the function `cloudsc`)
jphys = importlib.import_module("cloudsc_tpu.physics.cloudsc")


def _inp(ngptot=100):
    return load_input(REFERENCE_DATA, ngptot=ngptot, expand=False)


CASES = {
    "plain_fp64": (torch.float64, {}),
    "plain_fp32": (torch.float32, {}),
    "folded_fp64": (torch.float64, dict(fold=True)),
    "aerosol_fp64": (torch.float64, "aerosol"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scan_pack_bitwise_equals_plain_dict(params, case):
    dtype, kw = CASES[case]
    inp, cfg = _inp(), None
    if kw == "aerosol":
        inp, params, cfg = synthetic.version_case("aerosol", inp, params)
        kw = {}
    fields = tcloudsc.make_inputs(inp, dtype, **kw)
    want = tcloudsc.cloudsc(fields, params, inp.ptsphy, cfg)
    packed = tcloudsc.scan_pack(fields, params, inp.ptsphy, cfg)
    assert set(packed) == {"stack_s", "stack_p", "stack_h", "zqx0", "zlneg",
                           "pvfl", "pvfi", "land", "ldcum", "ktype"}
    nlev = inp.klev
    c = tscheme.derived_consts(params, inp.ptsphy, dtype, cfg)
    assert packed["stack_s"].shape == (nlev, len(tcloudsc._scan_s_rows(c)),
                                       100)
    assert packed["stack_h"].shape == (nlev + 1, 3, 100)
    got = tcloudsc.cloudsc(packed, params, inp.ptsphy, cfg)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("aer", [False, True], ids=["no_aer", "aer"])
def test_scan_stack_rows_are_the_jax_modules(params, aer):
    import copy

    p = copy.deepcopy(params)
    for flag in synthetic.AEROSOL_FLAGS:
        setattr(p.ydecldp, flag, aer)
    cfg = tscheme.SchemeConfig(iwarmrain=1)
    c = tscheme.derived_consts(p, 3600.0, torch.float64, cfg)
    from cloudsc_tpu.physics.scheme import SchemeConfig, derived_consts

    jc = derived_consts(p, 3600.0, jnp.float64, SchemeConfig(iwarmrain=1))
    assert tcloudsc._scan_s_rows(c) == jphys._scan_s_rows(jc)
    assert tcloudsc._SCAN_P_ROWS == jphys._SCAN_P_ROWS
    assert tcloudsc._SCAN_H_ROWS == jphys._SCAN_H_ROWS


def test_scan_pack_matches_jax_scan_pack(params):
    """fp64, 100 columns: the port's pre-packed step against the JAX
    engine's, each within FP64_TOL (errsum/refsum) per field."""
    inp = _inp()
    jfields = jmake_inputs(inp, jnp.float64)
    ref = jax.jit(lambda f: jphys.cloudsc(
        jphys.scan_pack(f, params, inp.ptsphy), params, inp.ptsphy))(jfields)
    fields = tcloudsc.make_inputs(inp, torch.float64)
    out = tcloudsc.cloudsc(tcloudsc.scan_pack(fields, params, inp.ptsphy),
                           params, inp.ptsphy)
    bad = {name: relerr(getattr(out, name).numpy(), np.asarray(getattr(
        ref, name))) for name in ref._fields}
    bad = {k: v for k, v in bad.items() if not v < FP64_TOL}
    assert not bad, bad


@pytest.mark.parametrize("form", ["fold_curves", "fold_newton", "fold_dep"])
def test_scan_pack_refuses_folded_form_dicts(params, form):
    fields = tcloudsc.make_inputs(_inp(), torch.float64, fold=True,
                                  params=params, **{form: True})
    with pytest.raises(ValueError, match="scan_pack"):
        tcloudsc.scan_pack(fields, params, 3600.0)


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]],
                         ids=["one", "mesh"])
def test_driver_scan_packed_switch(params, devices, monkeypatch):
    """CLOUDSC_SCAN_PACKED=1, read once at construction: each device's
    share packed once after the copy, the name `scan/cyclic+packed`, and
    the plain dict's outputs bit for bit (256 columns, NPROMA 64)."""
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    monkeypatch.delenv("CLOUDSC_SCAN_PACKED", raising=False)
    inp = _inp(256)
    kw = dict(device="cpu") if devices is None else dict(devices=devices)
    base, _, _ = CloudscDriver(params, inp.ptsphy, torch.float64,
                               backend="scan", nproma=64, **kw).run(inp)
    monkeypatch.setenv("CLOUDSC_SCAN_PACKED", "1")
    d = CloudscDriver(params, inp.ptsphy, torch.float64, backend="scan",
                      nproma=64, **kw)
    assert d.scan_packed and d.config_name("plain") == "scan/cyclic+packed"
    payloads = d._prepack(d.shard(d.prepare(inp)))
    assert all("stack_s" in p for p in payloads)
    out, _, _ = d.run(inp)
    for name, a, b in zip(base._fields, out, base):
        np.testing.assert_array_equal(a, b, err_msg=name)
