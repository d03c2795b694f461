"""K1 on the unfolded contracts on the CPU, against the JAX package: the
unfolded pack (CLOUDSC_FOLD_INPUTS=0), the per-field entry
(`cloudsc_fused_fields`, the port's `cloudsc_pallas(fields, ...)`), the
device-side `pack_inputs` and the driver's CLOUDSC_FOLD_INPUTS /
CLOUDSC_PACKED_STORAGE switches.

  * UNFOLDED_ROWS are `pallas_cloudsc._PACK_ROWS` and paph, the k+1 rows
    first; the unfolded pack is bit for bit the JAX `pack_inputs_raw(
    fold=False)` rows, cyclic and grouped, fp32 and fp64;
  * the plain unfolded K1 against `cloudsc_pallas(fields, interpret=True)`
    (the per-field Pallas kernel, which streams the same raw fields): fp64
    within rtol 1e-12 of each field's largest value
    (tests/test_fold_inputs.py's fp64 bar), fp32 within test_fp32_oracle's
    per-field p90 and outlier bounds (torch's and XLA's CPU exp differ by an
    ulp in fp32, test_torch_forms32.py);
  * the unfolded fp64 plain version against the port's scan engine at
    1e-12 (test_folded_fp64_tight's mirror), at 137 and at truncated level
    counts;
  * the fold does not degrade fp32 accuracy against the fp64 truth
    (test_fold_inputs.py::test_fold_does_not_degrade_fp32_accuracy's
    statistic, the port's plain version on both packs);
  * grouped and cyclic unfolded packs give bit for bit the same outputs
    after the ungroup; the per-field entry is bit for bit the unfolded
    pack's path; `pack_inputs(fold=True)` is the JAX function's pack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc_tpu.data import load_input
from cloudsc_tpu.data.expand import group_inverse
from cloudsc_tpu.kernels import pallas_cloudsc as pc
from cloudsc_tpu.params import Params
from cloudsc_tpu.physics import make_inputs as jmake_inputs
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.physics import cloudsc as tcloudsc
from cloudsc_tpu_torch.physics import scheme as tscheme
from cloudsc_tpu_torch.runtime import tracing

from conftest import REFERENCE_DATA

torch.set_num_threads(1)

FP64_RTOL = 1e-12  # tests/test_fold_inputs.py::test_folded_fp64_tight


def _inp(ngptot):
    return load_input(REFERENCE_DATA, ngptot=ngptot, expand=False)


def _compare(ref, out, rtol):
    """Every field's max abs difference within rtol of its largest value
    (tests/test_fold_inputs.py's _compare)."""
    for name in ref._fields:
        a = np.asarray(getattr(ref, name), np.float64)
        b = np.asarray(getattr(out, name), np.float64)
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
        assert err < rtol, f"{name}: maxrel={err:.3e}"


def _plain(p, c, fold_outputs=True):
    """The plain version on pack `p`, assembled, as numpy."""
    before = tracing.counter("ops.k1")
    out = cc.assemble(cc.cloudsc_fused(p, c, fold_outputs=fold_outputs), p,
                      c, fold_outputs)
    assert tracing.counter("ops.k1") == before
    return type(out)(*(a.numpy() for a in out))


def _unfolded(inp, params, dtype, order="cyclic", perm=None):
    return cc.pack_inputs_unfolded(inp, params, dtype=dtype, perm=perm,
                                   column_order=order)


def test_unfolded_rows_are_the_jax_pack_rows():
    assert len(cc.UNFOLDED_ROWS) == len(set(cc.UNFOLDED_ROWS)) == 27
    assert set(cc.UNFOLDED_ROWS) == set(pc._PACK_ROWS) | {"paph"}
    # the rows also read at level k+1 first (pallas_cloudsc._NEXT_FIELDS)
    assert cc.UNFOLDED_ROWS[:4] == (*pc._NEXT_FIELDS, "paph")
    assert cc.pack_rows(fn=False, fold_inputs=False) == cc.UNFOLDED_ROWS
    aer = ("pre_ice", "pccn")
    assert cc.pack_rows(fn=False, aer=aer, fold_inputs=False) == \
        cc.UNFOLDED_ROWS + aer
    # an unfolded pack has no folded row (fc, fd, in either ZDQS form);
    # the ZDQS row a field dict's build streams comes after its rows
    for form in (dict(fc=True, fn=False), dict(fd=True, fn=False),
                 dict(fc=True), dict(fd=True)):
        with pytest.raises(ValueError):
            cc.pack_rows(fold_inputs=False, **form)
        with pytest.raises(ValueError):
            cc.KernelVersion(fold_inputs=False, **form)
    assert cc.pack_rows(aer=aer, fold_inputs=False) == \
        cc.UNFOLDED_ROWS + (cc.ZDQS_ROW,) + aer
    assert cc.KernelVersion(fold_inputs=False).fn
    v = cc.KernelVersion(fold_inputs=False, fn=False)
    assert "-DCLOUDSC_FOLD_INPUTS=0" in v.macros()
    assert "-DCLOUDSC_FOLD_INPUTS=1" in cc.DEFAULT_VERSION.macros()


@pytest.mark.parametrize("fn", [False, True], ids=["inline", "zdqs_row"])
@pytest.mark.parametrize("aer", [False, True], ids=["no_aer", "aer"])
def test_unfolded_row_enum_matches_pack_rows(aer, fn):
    """cloudsc_scheme.cuh's `enum Row` under the unfolded build's macros is
    UNFOLDED_ROWS, the ZDQS row in a field dict's build (fn), and the
    couplings' aerosol rows."""
    from test_torch_engine import _row_enum

    v = cc.KernelVersion(iwarmrain=1 if aer else 2, laericesed=aer,
                         laericeauto=aer, laerliqautolsp=aer,
                         laerliqcoll=aer, fold_inputs=False, fn=fn)
    c = type("C", (), dict(LAERICESED=aer, LAERICEAUTO=aer,
                           LAERLIQAUTOLSP=aer, LAERLIQCOLL=aer,
                           IWARMRAIN=v.iwarmrain))
    names = _row_enum(v)
    assert names == [f"R_{n.upper()}" for n in cc.pack_rows(
        fn=fn, aer=cc.aer_rows(c), fold_inputs=False)] + ["R_COUNT"]


@pytest.mark.parametrize("order", ["cyclic", "grouped"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_unfolded_pack_bitwise_equals_jax(params, dtype, order):
    """The JAX unfolded pytree (pack, nxt, paph, col) row by row against the
    port's one array, at 300 columns."""
    inp = _inp(300)
    ncol, nlev = 300, inp.klev
    jp, _ = pc.pack_inputs_raw(inp, 4, params, dtype=getattr(jnp, dtype),
                               column_order=order, fold=False)
    p = _unfolded(inp, params, getattr(torch, dtype), order)
    assert p.form == {"fold_inputs": False, "fc": False, "fn": False,
                      "fd": False}
    assert p.pack.shape == (nlev + 1, 27, ncol)

    def flat(a, rows):
        return np.asarray(a).reshape(a.shape[0], rows, -1)[..., :ncol]

    pack = flat(jp["pack"], len(pc._PACK_ROWS))
    assert pack.shape[0] == nlev + 1
    for i, name in enumerate(pc._PACK_ROWS):
        np.testing.assert_array_equal(p.pack[:, p.row(name)].numpy(),
                                      pack[:, i], err_msg=name)
    np.testing.assert_array_equal(
        p.pack[:, p.row("paph")].numpy(),
        np.asarray(jp["paph"]).reshape(nlev + 1, -1)[:, :ncol])
    np.testing.assert_array_equal(
        p.col.numpy(), np.asarray(jp["col"]).reshape(4, -1)[:, :ncol])


@pytest.fixture(scope="module")
def pallas_fields():
    """The JAX per-field Pallas kernel (interpret mode) at 100 columns,
    fp64 and fp32, on make_inputs' plain dict."""
    from cloudsc_tpu.kernels import cloudsc_pallas

    inp = _inp(100)
    params = Params.from_input(inp)
    out = {}
    for dtype in ("float64", "float32"):
        fields = jmake_inputs(inp, getattr(jnp, dtype))
        out[dtype] = jax.block_until_ready(cloudsc_pallas(
            fields, params, inp.ptsphy, sublanes=1, interpret=True))
    return inp, params, out


def test_plain_unfolded_matches_pallas_fields_fp64(pallas_fields):
    inp, params, ref = pallas_fields
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float64)
    out = _plain(_unfolded(inp, params, torch.float64), c)
    _compare(ref["float64"], out, FP64_RTOL)


def test_plain_unfolded_matches_pallas_fields_fp32(pallas_fields):
    from test_fp32_oracle import OUTLIER_FRAC_BOUND, P90_BOUND, _field_stats

    inp, params, ref = pallas_fields
    ref = ref["float32"]
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float32)
    out = _plain(_unfolded(inp, params, torch.float32), c)
    for name in ref._fields:
        assert np.isfinite(getattr(out, name)).all(), name
    ref64 = type(ref)(*(np.asarray(a, np.float64) for a in ref))
    stats = _field_stats(ref64, out)
    bad = {name: s for name, s in stats.items()
           if not (s[0] <= P90_BOUND[name] and s[1] <= OUTLIER_FRAC_BOUND)}
    assert not bad, f"unfolded fp32: plain version vs Pallas kernel: {bad}"


def _truncated(inp, nlev):
    from test_level_generality import _truncated as cut

    return cut(inp, nlev) if nlev != inp.klev else inp


@pytest.mark.parametrize("nlev", [137, 61, 68, 91])
def test_unfolded_fp64_tight(params, nlev):
    """The unfolded fp64 plain version against the port's scan engine on
    the plain dict: the same sums at the same precision, the level loop
    and the flux sums in another order, within 1e-12 (the mirror of
    test_folded_fp64_tight), at L137 and at truncated level counts."""
    inp = _truncated(_inp(100), nlev)
    ref = tcloudsc.cloudsc(tcloudsc.make_inputs(inp, torch.float64), params,
                           inp.ptsphy)
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float64)
    p = _unfolded(inp, params, torch.float64)
    assert p.nlev == nlev
    out = _plain(p, c)
    assert out.pfplsl.shape == (nlev + 1, 100)
    _compare(type(ref)(*(a.numpy() for a in ref)), out, FP64_RTOL)


def test_fold_does_not_degrade_fp32_accuracy(params):
    """tests/test_fold_inputs.py's statistic on the port's plain version:
    against the fp64 truth the folded fp32 run's p90 error per field is
    within twice the unfolded one's (or under ~8 fp32 ulps of the field's
    scale)."""
    inp = _inp(512)
    ref64 = tcloudsc.cloudsc(tcloudsc.make_inputs(inp, torch.float64),
                             params, inp.ptsphy)
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float32)
    outs = {}
    for fold in (False, True):
        p = cc.pack_inputs_raw(inp, params, dtype=torch.float32,
                               column_order="cyclic", fold_inputs=fold,
                               fn=False)
        outs[fold] = _plain(p, c)
    worse = []
    for name in ref64._fields:
        t = getattr(ref64, name).numpy()
        scale = max(np.abs(t).max(), 1e-30)
        p90 = {fold: np.quantile(np.abs(np.asarray(getattr(outs[fold], name),
                                                   np.float64) - t), 0.9)
               / scale for fold in (False, True)}
        if p90[True] > max(2.0 * p90[False], 1e-9):
            worse.append((name, p90[False], p90[True]))
    assert not worse, f"fold degraded fp32 accuracy: {worse}"


def test_unfolded_grouped_bitwise_equals_cyclic(params):
    """Grouped (activity-sorted) and cyclic unfolded packs: bit for bit the
    same outputs after the ungroup (512 columns, a multiple of the host's
    vector width)."""
    from cloudsc_tpu_torch.data.expand import activity_perm

    inp = _inp(512)
    klon = np.asarray(inp.fields["PT"]).shape[-1]
    perm = activity_perm(inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"],
                         inp.ptsphy, params.ydecldp.rlmin)
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float32)
    cyc = _plain(_unfolded(inp, params, torch.float32), c)
    grp = _plain(_unfolded(inp, params, torch.float32, "grouped", perm), c)
    inv = group_inverse(klon, 512, perm=perm)
    for name in cyc._fields:
        np.testing.assert_array_equal(getattr(grp, name)[..., inv],
                                      getattr(cyc, name), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fields_entry_bitwise_equals_unfolded_pack(params, dtype):
    """`cloudsc_fused_fields` on make_inputs' cyclic dict: its device pack
    (`pack_inputs`) is the host's unfolded pack bit for bit, and so are its
    outputs; `FusedStep` takes the dict too; no kernel launch on the CPU."""
    inp = _inp(128)
    tdt = getattr(torch, dtype)
    fields = tcloudsc.make_inputs(inp, tdt)
    host = _unfolded(inp, params, tdt)
    dev = cc.pack_inputs(fields, params)
    assert dev.form == host.form and dev.rows == host.rows
    assert torch.equal(dev.pack, host.pack) and torch.equal(dev.col, host.col)
    c = tscheme.derived_consts(params, inp.ptsphy, tdt)
    want = _plain(host, c)
    before = tracing.counter("ops.k1")
    got = cc.cloudsc_fused_fields(fields, params, inp.ptsphy)
    step = cc.FusedStep(params, inp.ptsphy, tdt)
    got_step = cc.assemble(step(fields), fields, step.c)
    assert tracing.counter("ops.k1") == before
    for name, a, b, s in zip(want._fields, got, want, got_step):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        np.testing.assert_array_equal(s.numpy(), b, err_msg=name)


@pytest.mark.parametrize("every_form", [False, True],
                         ids=["default_form", "fc_fn_fd"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pack_inputs_fold_matches_jax(params, dtype, every_form,
                                      monkeypatch):
    """`pack_inputs(fields, fold=True)`: the field dict folded at its own
    dtype, the environment's form (the default streams ZDQS; fc+fn+fd the
    curve and deposition rows too, computed in fp64), bit for bit the JAX
    function's pack."""
    for var in ("CLOUDSC_FOLD_INPUTS", "CLOUDSC_FOLD_CURVES",
                "CLOUDSC_FOLD_NEWTON", "CLOUDSC_FOLD_DEP"):
        monkeypatch.delenv(var, raising=False)
    if every_form:
        monkeypatch.setenv("CLOUDSC_FOLD_CURVES", "1")
        monkeypatch.setenv("CLOUDSC_FOLD_DEP", "1")
    inp = _inp(128)
    jp, _ = pc.pack_inputs(jmake_inputs(inp, getattr(jnp, dtype), host=True),
                           1, params, ptsphy=inp.ptsphy, fold=True)
    fields = tcloudsc.make_inputs(inp, getattr(torch, dtype))
    p = cc.pack_inputs(fields, params, None, inp.ptsphy, fold=True)
    assert p.form == {"fold_inputs": True, "fc": every_form, "fn": True,
                      "fd": every_form}
    assert p.rows == cc.pack_rows(every_form, True, every_form)
    want = np.asarray(jp["pack"]).reshape(inp.klev + 1, len(p.rows), -1)
    np.testing.assert_array_equal(p.pack.numpy(), want[..., :128])
    np.testing.assert_array_equal(
        p.col.numpy(), np.asarray(jp["col"]).reshape(4, -1)[:, :128])
    with pytest.raises(ValueError):
        cc.pack_inputs(fields, params, fold=True)


def test_k1_bytes_and_ring_of_the_unfolded_pack(params):
    """27 input rows against 19: the modeled bytes (10 level rows out,
    the vapour's zero cloud tendency among them) and the ring's shared
    memory (4 stages x 27 rows x 128 threads)."""
    inp = _inp(100)
    p = _unfolded(inp, params, torch.float32)
    nlev, n = inp.klev, 100
    assert cc.k1_bytes(p) == 4 * ((nlev + 1) * 27 * n + 4 * n
                                  + nlev * 10 * n + (nlev + 1) * 10 * n + n)
    assert cc.k1_bytes(p, False) == cc.k1_bytes(p) + 4 * (nlev + 1) * 4 * n
    assert cc.RING.smem_bytes(8, len(p.rows)) == 110592
    assert cc.RING.smem_bytes(4, len(p.rows)) == 55296


def test_driver_fold_inputs_and_packed_storage(params, monkeypatch):
    """CLOUDSC_FOLD_INPUTS=0: the unfolded pack, ZDQS off whatever
    CLOUDSC_FOLD_NEWTON says, the unfolded build; CLOUDSC_PACKED_STORAGE=0:
    the field dict, packed on its device each step; both bit for bit the
    plain unfolded step after the ungroup, 256 columns of the 100-column
    snapshot (grouped and cyclic), NPROMA 128 (no padding)."""
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    for var in ("CLOUDSC_FOLD_INPUTS", "CLOUDSC_FOLD_NEWTON",
                "CLOUDSC_PACKED_STORAGE", "CLOUDSC_FOLD_OUTPUTS"):
        monkeypatch.delenv(var, raising=False)
    inp = _inp(256)
    monkeypatch.setenv("CLOUDSC_FOLD_INPUTS", "0")
    monkeypatch.setenv("CLOUDSC_FOLD_NEWTON", "1")
    d = CloudscDriver(params, inp.ptsphy, torch.float32, "cpu")
    assert d.form == {"fold_inputs": False, "fc": False, "fn": False,
                      "fd": False}
    assert d.config_name("plain") == "plain/grouped+unfold+foldo"
    host = d.prepare(inp)
    assert not host.fold_inputs and host.rows == cc.UNFOLDED_ROWS
    v = cc.kernel_version(d.step.c, host.form)
    assert not (v.fold_inputs or v.fn) and v != cc.DEFAULT_VERSION
    packed, _, _ = d.run(inp)
    monkeypatch.setenv("CLOUDSC_PACKED_STORAGE", "0")
    f = CloudscDriver(params, inp.ptsphy, torch.float32, "cpu")
    assert not (f.packed or f.grouped)
    assert f.config_name("plain") == "plain/fields+unfold+foldo"
    assert isinstance(f.prepare(inp), dict)
    fields, _, _ = f.run(inp)
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float32)
    want = _plain(_unfolded(inp, params, torch.float32), c)
    for name, a, b in zip(want._fields, packed, fields):
        np.testing.assert_array_equal(a, getattr(want, name), err_msg=name)
        np.testing.assert_array_equal(b, getattr(want, name), err_msg=name)
