"""The port's eager scan engine, its on-device validation and K1's scheme
versions, on the CPU, against the JAX package.

  * `make_inputs` (plain, and folded with the ZDQS row) is bitwise the JAX
    package's, fp32 and fp64, in cyclic and in activity-sorted grouped
    order;
  * the eager `cloudsc` against the JAX scan engine in fp64 within
    test_golden's FP64_TOL (errsum/refsum) for the reference configuration,
    the four single alternates and the aerosol couplings (the rain
    evaporation alternate on a raining input, the couplings on synthetic
    aerosol values: `data.synthetic`); the reference configuration also
    against reference.h5 within FP64_TOL, and in fp32 within
    test_fp32_oracle's per-field bounds of the JAX fp64 oracle;
  * the kernel's plain version against the Pallas kernel (interpret mode)
    on the same folded pack, fp64, within FP64_TOL, for the same six cases;
  * `device_field_norms` on CPU tensors against the JAX package's (x64) and
    the port's host `validate_outputs`, within 1e-12 relative;
    `validate_from_norms` prints the JAX package's table;
  * the CLI with `--iwarmrain 1`, `--kernel scan` and `--kernel auto`,
    against the JAX CLI's table, within 1e-12 relative per number above
    the engines' round-off;
  * the scheme-version macros reach the build, the source refuses to build
    without them, and the aerosol build's `enum Row` is its pack's rows.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc_tpu.data import load_input
from cloudsc_tpu.data.expand import activity_perm
from cloudsc_tpu.kernels import pallas_cloudsc as pc
from cloudsc_tpu.params import Params
from cloudsc_tpu.physics import cloudsc as jcloudsc
from cloudsc_tpu.physics import make_inputs as jmake_inputs
from cloudsc_tpu.physics.scheme import SchemeConfig as JConfig
from cloudsc_tpu_torch.data import synthetic
from cloudsc_tpu_torch.kernels import build
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.physics import cloudsc as tcloudsc
from cloudsc_tpu_torch.physics import scheme as tscheme
from cloudsc_tpu_torch import validate as tvalidate
from cloudsc_tpu_torch.runtime import tracing

from conftest import REFERENCE_DATA, relerr
from test_golden import FP64_TOL

torch.set_num_threads(1)

# the reference configuration and VERSION_CASES
CASES = ["reference", *synthetic.VERSION_CASES]


def _inp(ngptot):
    return load_input(REFERENCE_DATA, ngptot=ngptot, expand=False)


def _case(name, ngptot):
    """(input, params, (iwarmrain, ievaprain, ievapsnow, idepice)) of a
    CASES entry, for both packages (the JAX package's InputData and Params
    take the same copies)."""
    inp = _inp(ngptot)
    params = Params.from_input(inp)
    if name == "reference":
        return inp, params, (2, 2, 1, 1)
    inp, params, cfg = synthetic.version_case(name, inp, params)
    return inp, params, (cfg.iwarmrain, cfg.ievaprain, cfg.ievapsnow,
                         cfg.idepice)


def _bad_fields(out, ref, tol=FP64_TOL):
    bad = {}
    for name in ref._fields:
        got = np.asarray(getattr(out, name))
        want = np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        err = relerr(got, want)
        if not err < tol:
            bad[name] = err
    return bad


@pytest.mark.parametrize("order", ["cyclic", "grouped"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fold", [False, True], ids=["plain", "folded"])
def test_make_inputs_bitwise_equals_jax(params, fold, dtype, order):
    """300 columns: every field, its dtype and shape, in the cyclic order
    and in the activity-sorted grouped order."""
    inp = _inp(300)
    perm = None
    if order == "grouped":
        perm = activity_perm(inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"],
                             inp.ptsphy, params.ydecldp.rlmin)
    kw = dict(column_order=order, column_perm=perm, fold=fold,
              fold_newton=fold, params=params)
    want = jmake_inputs(inp, getattr(jnp, dtype), **kw)
    got = tcloudsc.make_inputs(inp, getattr(torch, dtype), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert ("zdqs" in got) == fold
    # the folded curve and deposition rows are ported too (every form of
    # them: tests/test_torch_forms.py)
    if fold:
        kw.update(fold_curves=True, fold_dep=True)
        want = jmake_inputs(inp, getattr(jnp, dtype), **kw)
        got = tcloudsc.make_inputs(inp, getattr(torch, dtype), **kw)
        assert sorted(got) == sorted(want)
        for k in ("zqsmix", "zfoeeice", "zdep0", "zinfac"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_engine_matches_jax_scan_fp64(case):
    """100 columns: the eager engine against the JAX scan engine on the
    same plain field dict."""
    inp, params, cfg = _case(case, 100)
    fields = jmake_inputs(inp, jnp.float64)
    ref = jax.jit(lambda f: jcloudsc(f, params, inp.ptsphy,
                                     config=JConfig(*cfg)))(fields)
    out = tcloudsc.cloudsc(tcloudsc.make_inputs(inp, torch.float64), params,
                           inp.ptsphy, tscheme.SchemeConfig(*cfg))
    out = type(ref)(*(a.numpy() for a in out))
    assert not _bad_fields(out, ref), f"{case}: {_bad_fields(out, ref)}"
    if case == "ievaprain1":
        # the raining input reaches the rain flux diagnostics
        assert np.asarray(ref.pfplsl).max() > 1.0e-5


def test_engine_folded_matches_jax_folded_scan(params, input_100):
    """The folded contract with the streamed ZDQS row, fp64."""
    kw = dict(fold=True, fold_newton=True, params=params)
    ref = jax.jit(lambda f: jcloudsc(f, params, input_100.ptsphy))(
        jmake_inputs(input_100, jnp.float64, **kw))
    out = tcloudsc.cloudsc(tcloudsc.make_inputs(input_100, torch.float64, **kw),
                           params, input_100.ptsphy)
    out = type(ref)(*(a.numpy() for a in out))
    assert not _bad_fields(out, ref)


def test_engine_matches_reference_fp64(input_100, params, reference_100):
    from cloudsc_tpu.validate import FIELD_ATTR, REF_DATASET, VALIDATION_ORDER

    out = tcloudsc.cloudsc(tcloudsc.make_inputs(input_100, torch.float64),
                           params, input_100.ptsphy)
    bad = {}
    for name, _ in VALIDATION_ORDER:
        got = getattr(out, FIELD_ATTR[name]).numpy()
        want = reference_100[REF_DATASET[name]]
        assert got.shape == want.shape, name
        err = relerr(got, want)
        if not err < FP64_TOL:
            bad[name] = err
    assert not bad, f"eager engine vs reference.h5: {bad}"


def test_engine_fp32_within_oracle_bounds(input_100, params,
                                          golden_outputs_fp64):
    """fp32 against the JAX fp64 oracle, under test_fp32_oracle's per-field
    p90 bound and outlier fraction."""
    from test_fp32_oracle import OUTLIER_FRAC_BOUND, P90_BOUND, _field_stats

    out = tcloudsc.cloudsc(tcloudsc.make_inputs(input_100, torch.float32),
                           params, input_100.ptsphy)
    assert out.plude.dtype == torch.float32
    stats = _field_stats(golden_outputs_fp64,
                         type(golden_outputs_fp64)(*(a.numpy() for a in out)))
    bad = {name: s for name, s in stats.items()
           if not (s[0] <= P90_BOUND[name] and s[1] <= OUTLIER_FRAC_BOUND)}
    assert not bad, f"fp32 eager engine vs the fp64 oracle: {bad}"


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_fp64(case):
    """128 columns, cyclic: the kernel's plain version and the Pallas kernel
    (interpret mode) on the same folded pack of the case's scheme version,
    aerosol rows included."""
    inp, params, cfg = _case(case, 128)
    jp, _ = pc.pack_inputs_raw(inp, 1, params, JConfig(*cfg),
                               dtype=jnp.float64, column_order="cyclic",
                               fold=True)
    ref = pc.cloudsc_pallas(None, params, inp.ptsphy, sublanes=1,
                            packed=jax.device_put(jp), ncol_packed=128,
                            config=JConfig(*cfg), interpret=True)
    tcfg = tscheme.SchemeConfig(*cfg)
    p = cc.pack_inputs_folded(inp, params, tcfg, dtype=torch.float64,
                              column_order="cyclic")
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float64, tcfg)
    assert p.rows == cc.pack_rows(aer=cc.aer_rows(c))
    np.testing.assert_array_equal(
        p.pack.numpy(),
        np.asarray(jp["pack"]).reshape(p.pack.shape[0], len(p.rows), -1))
    out = cc.assemble(cc.cloudsc_fused(p, c), p, c)
    assert tracing.counter("ops.k1") == 0
    out = type(ref)(*(a.numpy() for a in out))
    assert not _bad_fields(out, ref), f"{case}: {_bad_fields(out, ref)}"


@pytest.fixture(scope="module")
def outputs_300(params):
    """fp64 kernel-plain-version outputs at 300 columns, cyclic."""
    inp = _inp(300)
    p = cc.pack_inputs_folded(inp, params, dtype=torch.float64,
                              column_order="cyclic")
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float64)
    return cc.assemble(cc.cloudsc_fused(p, c), p, c)


def test_device_norms_match_jax_and_host(outputs_300, capsys):
    """The norms on CPU tensors against the JAX package's jitted norms
    (x64) and the port's host path, per field and statistic; the table
    from the norms is the JAX package's, line for line."""
    from cloudsc_tpu import validate as jvalidate
    from cloudsc_tpu_torch import data as tdata

    ref_dev = tvalidate.reference_on_device(tdata.default_reference_path(),
                                            300, "cpu")
    host_ref = tdata.load_reference(tdata.default_reference_path(), 300)
    for k, v in ref_dev.items():
        np.testing.assert_array_equal(v.numpy(), host_ref[k], err_msg=k)
    norms = tvalidate.device_field_norms(outputs_300, ref_dev)
    assert norms.shape == (21, 5) and norms.dtype == torch.float64
    jnorms = np.asarray(jvalidate.device_field_norms(
        jcloudsc_outputs(outputs_300),
        {k: jnp.asarray(v) for k, v in host_ref.items()}))
    np.testing.assert_allclose(norms.numpy(), jnorms, rtol=1e-12, atol=0)
    host = tvalidate.validate_outputs(
        type(outputs_300)(*(a.numpy() for a in outputs_300)), host_ref,
        ngptotg=300, print_table=False)
    np.testing.assert_allclose(
        norms.numpy(),
        [[e.minval, e.maxval, e.maxerr, e.errsum, e.refsum] for e in host],
        rtol=1e-12, atol=0)
    capsys.readouterr()
    mine = tvalidate.validate_from_norms(norms.numpy(), 300, work_eps=2e-16)
    text = capsys.readouterr().out
    theirs = jvalidate.validate_from_norms(norms.numpy(), 300,
                                           work_eps=2e-16)
    assert capsys.readouterr().out == text and "MaxRelErr-%" in text
    assert [e.flagged for e in mine] == [e.flagged for e in theirs]


def jcloudsc_outputs(out):
    """A port CloudscOutputs as the JAX package's, on JAX arrays."""
    from cloudsc_tpu.physics.cloudsc import CloudscOutputs

    return CloudscOutputs(*(jnp.asarray(a.numpy()) for a in out))


_NUM = re.compile(r"-?\d\.\d{13}E[+-]\d\d")


def _column_values(field: str) -> int:
    """Values one column of a validated field holds (137 levels)."""
    if field == "PRAINFRAC_TOPRFZ":
        return 1
    if field == "TENDENCY_LOC%CLD":
        return 5 * 137
    return 138 if field.startswith("PF") else 137


def _table(text):
    """{field: [five numbers]} of a printed validation table."""
    rows = {}
    for line in text.splitlines():
        nums = _NUM.findall(line)
        if len(nums) == 5:
            rows[line.split()[0]] = [float(n) for n in nums]
    return rows


@pytest.fixture(scope="module")
def jax_cli_table():
    from cloudsc_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["1", "100", "16", "--platform", "cpu", "--precision",
                     "fp64", "--iwarmrain", "1"]) == 0
    return _table(buf.getvalue())


@pytest.mark.parametrize("kernel", ["scan", "auto"])
def test_cli_iwarmrain1_matches_jax_cli(jax_cli_table, kernel):
    """`--iwarmrain 1` against reference.h5 (the reference configuration's
    goldens), so the errors are the alternate's physics, not round-off:
    MinValue and MaxValue within 1e-12 relative of the JAX CLI's; AbsMaxErr
    within 1e-12 relative or 1e-15 of the field's largest value, and
    AvgAbsErr (a column's values summed) within 1e-12 relative or 1e-15 of
    the largest value for each value a column holds. The errors are
    differences of two fp64 engines' fields, and one that is small against
    its field (PFSQIF: 1.8e-12 on a 3.9e-6 flux) carries each engine's own
    round-off of the field: measured 1e-19 on PFSQIF's AvgAbsErr, summed
    over 138 half levels, 1e-7 of the statistic. A statistic both engines
    leave below 1e-12 of its field's largest value is round-off alone (the
    alternate does not touch TENDENCY_LOC%A: 2.0e-17 and 7.0e-18 on a field
    of 2.8e-4) and is not compared."""
    from cloudsc_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["1", "100", "16", "--device", "cpu", "--precision",
                     "fp64", "--iwarmrain", "1", "--kernel", kernel]) == 0
    mine = _table(buf.getvalue())
    assert mine.keys() == jax_cli_table.keys() and len(mine) == 21
    for field, want in jax_cli_table.items():
        got = mine[field]
        scale = max(abs(want[0]), abs(want[1]))
        np.testing.assert_allclose(got[:2], want[:2], rtol=1e-12, atol=0,
                                   err_msg=field)
        for g, w, n in ((got[2], want[2], 1),
                        (got[3], want[3], _column_values(field))):
            if max(g, w) > 1e-12 * scale:
                np.testing.assert_allclose(g, w, rtol=1e-12,
                                           atol=1e-15 * scale * n,
                                           err_msg=field)
    # the flags: the alternate departs from the reference configuration's
    # goldens on the same fields in both
    flagged = {f for f, v in mine.items() if v[4] > 1e-9}
    assert flagged == {f for f, v in jax_cli_table.items() if v[4] > 1e-9}
    assert flagged


def _preprocess(src: str, macros: dict) -> str:
    """The lines of `src` that survive its #if/#else/#endif under `macros`
    (name -> int), with the #define'd expressions expanded."""
    defs = dict(macros)
    out, stack = [], []
    lines = iter(src.replace("\\\n", " ").splitlines())

    def value(expr):
        expr = re.sub(r"defined\((\w+)\)", lambda m: str(int(m.group(1) in defs)),
                      expr)
        expr = re.sub(r"\b[A-Z_][A-Z0-9_]*\b",
                      lambda m: f"({defs.get(m.group(0), 0)})", expr)
        expr = expr.replace("||", " or ").replace("&&", " and ")
        expr = re.sub(r"!(?!=)", " not ", expr)
        return bool(eval(expr))

    for line in lines:
        s = line.strip()
        live = all(stack)
        if s.startswith("#if "):
            stack.append(live and value(s[4:]))
        elif s.startswith("#else"):
            stack[-1] = not stack[-1] and all(stack[:-1])
        elif s.startswith("#endif"):
            stack.pop()
        elif live and s.startswith("#define "):
            name, expr = s[8:].split(None, 1)
            defs[name] = int(value(expr))
        elif live:
            out.append(line)
    return "\n".join(out)


def _version_macros(version) -> dict:
    flags = build.nvcc_flags(version=version)
    return {m.group(1): int(m.group(2)) for f in flags
            if (m := re.fullmatch(r"-D(CLOUDSC_\w+)=(\d+)", f))}


def _row_enum(version) -> list:
    src = (build.CSRC / "cloudsc_scheme.cuh").read_text()
    body = re.search(r"enum Row \{(.*?)\};",
                     _preprocess(src, _version_macros(version)), re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [t.strip() for t in body.split(",") if t.strip()]


@pytest.mark.parametrize("case", CASES)
def test_version_macros_reach_the_build(case):
    """Each version's switches and couplings become the CLOUDSC_* flags of
    its own build (a hash of its own), the source refuses to build without
    any of them, and `enum Row` under those macros is the version's pack
    rows (the aerosol build's 24 included)."""
    inp, params, cfg = _case(case, 100)
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float32,
                               tscheme.SchemeConfig(*cfg))
    v = cc.kernel_version(c)
    macros = _version_macros(v)
    assert macros == {
        "CLOUDSC_RING_STAGES": cc.RING.stages,
        "CLOUDSC_RING_BLOCK": cc.RING.block,
        "CLOUDSC_RING_MIN_BLOCKS": cc.RING.min_blocks,
        "CLOUDSC_IWARMRAIN": c.IWARMRAIN, "CLOUDSC_IEVAPRAIN": c.IEVAPRAIN,
        "CLOUDSC_IEVAPSNOW": c.IEVAPSNOW, "CLOUDSC_IDEPICE": c.IDEPICE,
        "CLOUDSC_LAERICESED": int(c.LAERICESED),
        "CLOUDSC_LAERICEAUTO": int(c.LAERICEAUTO),
        "CLOUDSC_LAERLIQAUTOLSP": int(c.LAERLIQAUTOLSP and c.IWARMRAIN == 1),
        "CLOUDSC_LAERLIQCOLL": int(c.LAERLIQCOLL and c.IWARMRAIN == 1),
        # the main path's form (the folded pack streaming ZDQS, the
        # derivable flux rows folded out), no skipped section, dynamic
        # skips on
        "CLOUDSC_FC": 0, "CLOUDSC_FN": 1, "CLOUDSC_FD": 0,
        "CLOUDSC_FOLD_INPUTS": 1, "CLOUDSC_FOLD_OUTPUTS": 1,
        "CLOUDSC_DYNAMIC_SKIPS": 1, "CLOUDSC_S521_ROUND_SKIP": 0,
        **{f"CLOUDSC_SKIP_{t.upper()}": 0 for t in tscheme.SKIP_TAGS},
    }
    src = (build.CSRC / "cloudsc_scheme.cuh").read_text()
    guard = re.search(r"#if (!defined.*?)\n#error", src.replace("\\\n", " "),
                      re.S).group(1)
    for name in macros:
        if not name.startswith("CLOUDSC_RING"):
            assert f"!defined({name})" in guard, name
    rows = _row_enum(v)
    assert rows[-1] == "R_COUNT"
    assert rows[:-1] == [f"R_{n.upper()}"
                         for n in cc.pack_rows(aer=cc.aer_rows(c))]
    default = build.source_hash(build.nvcc_flags())
    assert (build.source_hash(build.nvcc_flags(version=v)) == default) == \
        (case == "reference")


def test_kernel_version_normalises_unread_couplings(params):
    """The liquid couplings act only under IWARMRAIN=1: elsewhere they
    share the uncoupled build; `build` names K1's source alone for a
    version other than the reference's."""
    _, p2 = synthetic.aerosol(_inp(100), params)
    c = tscheme.derived_consts(p2, 3600.0, torch.float32)
    v = cc.kernel_version(c)
    assert (v.laericesed, v.laericeauto) == (True, True)
    assert not (v.laerliqautolsp or v.laerliqcoll)
    assert cc.aer_rows(c) == ["pre_ice", "picrit_aer", "pnice"]
    assert build._version_sources(None, v) == (
        [build.CSRC / "cloudsc_fused.cu"], v)
    assert build._version_sources(None, cc.DEFAULT_VERSION) == (None, None)
