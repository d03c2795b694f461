"""K1's forms on the CPU: the port's folded rows, packs and plain version in
every form of the Pallas kernel, against the JAX package.

  * `make_inputs(fold_curves=, fold_dep=)` is bitwise the JAX package's
    `make_inputs(host=True)`, fp32 and fp64, the deposition rows following
    the configuration's IDEPICE;
  * `pack_rows` is `pallas_cloudsc._pack_rows_f` for all eight (fc, fn, fd)
    forms, with and without aerosol rows, and the fc+fn+fd pack is bitwise
    the JAX package's;
  * the plain version in fp64, for fc+fn+fd, each single knob and fn off
    (the in-line CUADJTQ), against `cloudsc_pallas` in interpret mode on
    the same pack (as tests/test_satfold.py runs it): every field within
    test_pallas's rtol 1e-5 and test_golden's FP64_TOL. The fp32 twins are
    in test_torch_forms32.py, the skips in test_torch_skips.py and the
    activity probe and the host-compiled forms in test_torch_probe.py (one
    file a worker under `--dist loadfile`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc_tpu.data import load_input
from cloudsc_tpu.kernels import pallas_cloudsc as pc
from cloudsc_tpu.params import Params
from cloudsc_tpu.physics import make_inputs as jmake_inputs
from cloudsc_tpu.physics.scheme import SchemeConfig as JConfig
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.physics import cloudsc as tcloudsc
from cloudsc_tpu_torch.physics import scheme as tscheme
from cloudsc_tpu_torch.runtime import tracing

from conftest import REFERENCE_DATA, relerr
from test_golden import FP64_TOL
from test_pallas import _compare

torch.set_num_threads(1)

FORMS = {"fc_fn_fd": (True, True, True), "fc": (True, False, False),
         "fd": (False, False, True), "fn_off": (False, False, False)}


def _inp(ngptot):
    return load_input(REFERENCE_DATA, ngptot=ngptot, expand=False)


def _set_form(monkeypatch, fc, fn, fd):
    """The JAX package's pack reads its form from the environment."""
    for var, on in (("CLOUDSC_FOLD_CURVES", fc), ("CLOUDSC_FOLD_NEWTON", fn),
                    ("CLOUDSC_FOLD_DEP", fd)):
        monkeypatch.setenv(var, "1" if on else "0")


@pytest.mark.parametrize("idepice", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_inputs_folds_bitwise_equal_jax(params, dtype, idepice):
    inp = _inp(300)
    kw = dict(fold=True, fold_curves=True, fold_newton=True, fold_dep=True,
              params=params)
    want = jmake_inputs(inp, getattr(jnp, dtype), host=True,
                        config=JConfig(idepice=idepice), **kw)
    got = tcloudsc.make_inputs(inp, getattr(torch, dtype),
                               config=tscheme.SchemeConfig(idepice=idepice),
                               **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    for k in cc.CURVE_ROWS + cc.DEP_ROWS + ("zdqs",):
        assert k in got, k


@pytest.mark.parametrize("aer", [False, True], ids=["no_aer", "aer"])
@pytest.mark.parametrize("fd", [False, True])
@pytest.mark.parametrize("fn", [False, True])
@pytest.mark.parametrize("fc", [False, True])
def test_pack_rows_equal_jax(fc, fn, fd, aer):
    from types import SimpleNamespace

    # every aerosol coupling under IWARMRAIN=1, or none
    c = SimpleNamespace(LAERICESED=aer, LAERICEAUTO=aer, LAERLIQAUTOLSP=aer,
                        LAERLIQCOLL=aer, IWARMRAIN=1)
    rows = list(pc._pack_rows_f(fc, fn, fd)) + pc._aer_rows(c)
    assert list(cc.pack_rows(fc, fn, fd, cc.aer_rows(c))) == rows
    assert len(rows) == 18 + 9 * fc + fn + 2 * fd + 5 * aer


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_form_pack_bitwise_equals_jax(params, dtype, monkeypatch):
    """The fc+fn+fd pack and the fn-off pack, cyclic order, bit for bit."""
    inp = _inp(300)
    tdt = getattr(torch, dtype)
    for fc, fn, fd in ((True, True, True), (False, False, False)):
        _set_form(monkeypatch, fc, fn, fd)
        jp, _ = pc.pack_inputs_raw(inp, 4, params, dtype=getattr(jnp, dtype),
                                   column_order="cyclic", fold=True)
        p = cc.pack_inputs_folded(inp, params, dtype=tdt, fc=fc, fn=fn, fd=fd,
                                  column_order="cyclic")
        assert (p.fc, p.fn, p.fd) == (fc, fn, fd)
        assert p.rows == cc.pack_rows(fc, fn, fd)
        want = np.asarray(jp["pack"]).reshape(inp.klev + 1, len(p.rows),
                                               -1)[..., :300]
        np.testing.assert_array_equal(p.pack.numpy(), want)


def pallas_and_plain(form, dtype, monkeypatch, ncol=512):
    """(JAX Pallas kernel in interpret mode, the port's plain version after
    assemble) on the same cyclic pack of `form`, at `ncol` columns."""
    fc, fn, fd = FORMS[form]
    inp = _inp(ncol)
    params = Params.from_input(inp)
    _set_form(monkeypatch, fc, fn, fd)
    jp, _ = pc.pack_inputs_raw(inp, 4, params, dtype=getattr(jnp, dtype),
                               column_order="cyclic", fold=True)
    assert jp["pack"].shape[1] == len(pc._pack_rows_f(fc, fn, fd))
    ref = pc.cloudsc_pallas(None, params, inp.ptsphy, sublanes=4,
                            packed=jax.device_put(jp), ncol_packed=ncol,
                            interpret=True)
    tdt = getattr(torch, dtype)
    p = cc.pack_inputs_folded(inp, params, dtype=tdt, fc=fc, fn=fn, fd=fd,
                              column_order="cyclic")
    c = tscheme.derived_consts(params, inp.ptsphy, tdt)
    before = tracing.counter("ops.k1")
    out = cc.assemble(cc.cloudsc_fused(p, c), p, c)
    assert tracing.counter("ops.k1") == before
    return ref, type(ref)(*(a.numpy() for a in out))


@pytest.mark.parametrize("form", list(FORMS))
def test_plain_form_matches_pallas_interpret_fp64(form, monkeypatch):
    ref, out = pallas_and_plain(form, "float64", monkeypatch)
    _compare(ref, out, rtol=1e-5)
    bad = {name: relerr(getattr(out, name), getattr(ref, name))
           for name in ref._fields
           if not relerr(getattr(out, name), getattr(ref, name)) < FP64_TOL}
    assert not bad, f"{form}: plain version vs Pallas kernel: {bad}"
