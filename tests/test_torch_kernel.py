"""The port's fused-step module (cloudsc_tpu_torch.kernels.cuda_cloudsc) on
the CPU: its host pack, its plain version and the CUDA wrapper's contract.

  * the folded pack is bitwise the JAX package's (pack_inputs_raw, folded,
    grouped, activity-sorted), fp32 and fp64;
  * the plain version, after `assemble`, is within test_golden's FP64_TOL of
    the JAX folded scan in fp64, and within test_pallas's rtol 1e-5 of the
    Pallas kernel (interpret mode) in fp32 on the same pack;
  * the cyclic pack is bitwise the JAX package's cyclic folded pack;
  * the plain `floor` / `init` bodies, after `assemble`, match the Pallas
    kernel's diagnostic bodies (`_mode`, interpret mode) on the same pack;
  * a CPU pack takes the plain version and launches nothing;
  * the constants / row enums of the CUDA source match the Python layout;
  * the wrapper's argument check takes every scheme version and refuses
    what no build takes;
  * the kernel's input ring: its geometry reaches the source, its occupancy
    query is declared, and a replay of `ring_schedule` shows every read
    complete and no stage overwritten before its last reader;
  * the CUDA scheme header, compiled for the host for each scheme version,
    against the plain version.
"""

import ctypes
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc_tpu.data import load_input
from cloudsc_tpu.data.expand import activity_perm
from cloudsc_tpu.kernels import pallas_cloudsc as pc
from cloudsc_tpu.params import Params
from cloudsc_tpu.physics import cloudsc, make_inputs
from cloudsc_tpu.physics import satfold as jsatfold
from cloudsc_tpu.physics import scheme as jscheme
from cloudsc_tpu_torch.data import synthetic
from cloudsc_tpu_torch.kernels import build
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.physics import satfold as tsatfold
from cloudsc_tpu_torch.physics import scheme as tscheme
from cloudsc_tpu_torch.runtime import tracing

from conftest import REFERENCE_DATA, relerr
from test_golden import FP64_TOL
from test_pallas import _compare

torch.set_num_threads(1)


def _k1_counts():
    """K1's launches by body: full, floor, init."""
    return (tracing.counter("ops.k1"), tracing.counter("launches.k1.floor"),
            tracing.counter("launches.k1.init"))


def _inp(ngptot):
    return load_input(REFERENCE_DATA, ngptot=ngptot, expand=False)


def _perm(inp, params):
    return activity_perm(inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"],
                         inp.ptsphy, params.ydecldp.rlmin)


def _jax_pack(inp, params, dtype, perm, sublanes=4):
    p, _ = pc.pack_inputs_raw(inp, sublanes, params, dtype=dtype,
                              column_order="grouped", column_perm=perm,
                              fold=True)
    return p


@pytest.mark.parametrize("ncol", [300, 1030])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pack_bitwise_equals_jax(params, dtype, ncol):
    inp = _inp(ncol)
    perm = _perm(inp, params)
    tdt = getattr(torch, dtype)
    p = cc.pack_inputs_folded(inp, params, dtype=tdt, perm=perm)
    jp = _jax_pack(inp, params, getattr(jnp, dtype), perm)
    nlev = inp.klev
    want = np.asarray(jp["pack"]).reshape(nlev + 1, len(p.rows), -1)[..., :ncol]
    want_col = np.asarray(jp["col"]).reshape(4, -1)[:, :ncol]
    assert p.rows == cc.pack_rows() and p.fn
    assert tuple(p.rows) == tuple(pc._pack_rows_f(False, True, False))
    assert p.pack.dtype == tdt and p.pack.is_contiguous()
    np.testing.assert_array_equal(p.pack.numpy(), want)
    np.testing.assert_array_equal(p.col.numpy(), want_col)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cyclic_pack_bitwise_equals_jax(params, dtype):
    inp = _inp(300)
    tdt = getattr(torch, dtype)
    p = cc.pack_inputs_folded(inp, params, dtype=tdt, column_order="cyclic")
    jp, _ = pc.pack_inputs_raw(inp, 4, params, dtype=getattr(jnp, dtype),
                               column_order="cyclic", fold=True)
    nlev = inp.klev
    want = np.asarray(jp["pack"]).reshape(nlev + 1, len(p.rows), -1)[..., :300]
    np.testing.assert_array_equal(p.pack.numpy(), want)
    np.testing.assert_array_equal(p.col.numpy(),
                                  np.asarray(jp["col"]).reshape(4, -1)[:, :300])
    with pytest.raises(ValueError, match="grouped"):
        cc.pack_inputs_folded(inp, params, dtype=tdt, perm=_perm(inp, params),
                              column_order="cyclic")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["floor", "init"])
def test_diagnostic_bodies_match_pallas_interpret(mode, dtype):
    """128 columns, cyclic order: the plain `floor` / `init` bodies (through
    the wrapper on a CPU pack) against `cloudsc_pallas(_mode=...)` in
    interpret mode, through each side's assemble. floor is one add: bitwise
    in both precisions. init is section 1: fp64 within rtol 1e-12 (torch's
    and XLA's libm differ by ulps in exp); fp32 within test_fp32_oracle's
    bounds, as test_plain_matches_pallas_interpret holds the full body."""
    from test_fp32_oracle import OUTLIER_FRAC_BOUND, P90_BOUND, _field_stats

    inp = _inp(128)
    params = Params.from_input(inp)
    jp, _ = pc.pack_inputs_raw(inp, 1, params, dtype=getattr(jnp, dtype),
                               column_order="cyclic", fold=True)
    ref = pc.cloudsc_pallas(None, params, inp.ptsphy, sublanes=1,
                            packed=jax.device_put(jp), ncol_packed=128,
                            interpret=True, _mode=mode)
    tdt = getattr(torch, dtype)
    p = cc.pack_inputs_folded(inp, params, dtype=tdt, column_order="cyclic")
    c = tscheme.derived_consts(params, inp.ptsphy, tdt)
    before = _k1_counts()
    out = cc.assemble(cc.cloudsc_fused(p, c, mode=mode), p, c)
    assert _k1_counts() == before
    out_np = type(ref)(*(a.numpy() for a in out))
    for name in ref._fields:
        assert getattr(out_np, name).shape == getattr(ref, name).shape, name
    if mode == "floor":
        for name in ref._fields:
            np.testing.assert_array_equal(getattr(out_np, name),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)
    elif dtype == "float64":
        for name in ref._fields:
            np.testing.assert_allclose(getattr(out_np, name),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-12, atol=0, err_msg=name)
    else:
        ref64 = type(ref)(*(np.asarray(a, np.float64) for a in ref))
        stats = _field_stats(ref64, out_np)
        bad = {name: s for name, s in stats.items()
               if not (s[0] <= P90_BOUND[name] and s[1] <= OUTLIER_FRAC_BOUND)}
        assert not bad, f"fp32 init body vs Pallas kernel: {bad}"
    # the body's value: prainfrac is the edge-replicated last level's
    v = out.plude
    np.testing.assert_array_equal(out.prainfrac_toprfz.numpy(), v[-1].numpy())


def test_satfold_copy_is_bitwise(input_100, params):
    """The port's numpy copy of satfold computes the JAX module's rows."""
    f = {k: np.asarray(v, np.float64) for k, v in input_100.fields.items()
         if np.asarray(v).dtype.kind == "f"}
    ztp1 = f["PT"] + input_100.ptsphy * f["TENDENCY_TMP_T"]
    cj = jscheme.derived_consts(params, input_100.ptsphy, jnp.float64)
    ct = tscheme.derived_consts(params, input_100.ptsphy, torch.float64)
    a = jsatfold.curve_rows(cj, ztp1, f["PAP"])
    b = tsatfold.curve_rows(ct, ztp1, f["PAP"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    args = (ztp1, f["PAP"], f["PAPH"], f["PMFU"] + f["PMFD"],
            f["PHRSW"] + f["PHRLW"], f["PVERVEL"], a["zqsmix"])
    np.testing.assert_array_equal(jsatfold.newton_zdqs(cj, *args),
                                  tsatfold.newton_zdqs(ct, *args))


@pytest.fixture(scope="module")
def plain_fp64_100(params):
    inp = _inp(100)
    p = cc.pack_inputs_folded(inp, params, dtype=torch.float64)
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float64)
    return inp, p, c, cc.assemble(cc.cloudsc_fused_plain(p, c), p, c)


@pytest.mark.parametrize("fn", [True, False], ids=["zdqs_row", "inline"])
def test_plain_matches_jax_folded_scan_fp64(params, plain_fp64_100, fn):
    """Both 3.4b forms: the streamed ZDQS row (the main path) and the pack
    without it, where the body runs the in-line CUADJTQ."""
    inp, _, c, out = plain_fp64_100
    if not fn:
        p = cc.pack_inputs_folded(inp, params, dtype=torch.float64, fn=False)
        assert p.rows == cc.pack_rows(fn=False) and not p.fn
        out = cc.assemble(cc.cloudsc_fused_plain(p, c), p, c)
    fields = make_inputs(inp, jnp.float64, fold=True, fold_newton=fn,
                         params=params)
    ref = jax.jit(lambda f: cloudsc(f, params, inp.ptsphy))(fields)
    bad = {}
    for name in ref._fields:
        got = getattr(out, name).numpy()
        want = np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        err = relerr(got, want)
        if not err < FP64_TOL:
            bad[name] = err
    assert not bad, f"plain version vs JAX folded scan: {bad}"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_matches_pallas_interpret(dtype):
    """512 columns: the plain version and the Pallas kernel (CPU interpret
    mode, as test_pallas.py runs it) on the same folded pack.

    fp64: test_pallas's bar, rtol 1e-5 on every field, and FP64_TOL on
    errsum/refsum (measured worst maxrel 9e-14) — the kernel's schedule
    (carries, NCLDTOP freeze, section-8 sums, folded-out rows) held exactly.
    fp32: torch's and XLA's CPU exp differ by an ulp (measured 1.5e-7 on
    the saturation pressure), which flips threshold branches and cancels in
    the flux sums (measured maxrel 0.32 on PFSQLF), so rtol 1e-5 cannot
    hold between the two fp32 engines; they are held to the repo's fp32
    engine guard instead (test_fp32_oracle: per-field p90 bound and outlier
    fraction; measured p90 <= 1.4e-7, outliers <= 0.0063)."""
    from test_fp32_oracle import OUTLIER_FRAC_BOUND, P90_BOUND, _field_stats

    inp = _inp(512)
    params = Params.from_input(inp)
    perm = _perm(inp, params)
    jp = _jax_pack(inp, params, getattr(jnp, dtype), perm)
    ref = pc.cloudsc_pallas(None, params, inp.ptsphy, sublanes=4,
                            packed=jax.device_put(jp), ncol_packed=512,
                            interpret=True)
    tdt = getattr(torch, dtype)
    p = cc.pack_inputs_folded(inp, params, dtype=tdt, perm=perm)
    c = tscheme.derived_consts(params, inp.ptsphy, tdt)
    out = cc.assemble(cc.cloudsc_fused_plain(p, c), p, c)
    out_np = type(ref)(*(a.numpy() for a in out))
    if dtype == "float64":
        _compare(ref, out_np, rtol=1e-5)
        for name in ref._fields:
            assert relerr(getattr(out_np, name), getattr(ref, name)) \
                < FP64_TOL, name
        return
    ref64 = type(ref)(*(np.asarray(a, np.float64) for a in ref))
    stats = _field_stats(ref64, out_np)
    bad = {name: s for name, s in stats.items()
           if not (s[0] <= P90_BOUND[name] and s[1] <= OUTLIER_FRAC_BOUND)}
    assert not bad, f"fp32 plain version vs Pallas kernel: {bad}"


def test_wrapper_takes_plain_version_on_cpu(plain_fp64_100):
    inp, p, c, want = plain_fp64_100
    before = tracing.counter("ops.k1")
    got = cc.assemble(cc.cloudsc_fused(p, c), p, c)
    assert tracing.counter("ops.k1") == before == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    step = cc.FusedStep(Params.from_input(inp), inp.ptsphy, torch.float64)
    for a, b in zip(cc.assemble(step(p), p, c), want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tracing.counter("ops.k1") == 0


def _c_enum(name: str) -> list:
    """The enumerators of `enum name` in cloudsc_scheme.cuh as the default
    build compiles it (its #if blocks under the reference configuration's
    macros)."""
    from test_torch_engine import _preprocess, _version_macros

    src = _preprocess((build.CSRC / "cloudsc_scheme.cuh").read_text(),
                      _version_macros(cc.DEFAULT_VERSION))
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [t.strip() for t in body.split(",") if t.strip()]


def test_const_names_match_c_enum(params):
    names = _c_enum("Const")
    assert names[-1] == "C_COUNT"
    assert names[:-1] == [f"C_{n}" for n in cc.CONST_NAMES]
    c = tscheme.derived_consts(params, 3600.0, torch.float32)
    v = cc.const_vector(c)
    assert v.dtype == torch.float64 and v.numel() == len(cc.CONST_NAMES)
    assert float(v[cc.CONST_NAMES.index("NCLDTOP")]) == 15.0
    assert float(v[cc.CONST_NAMES.index("zepsilon")]) == \
        100.0 * float(np.finfo(np.float32).eps)


def test_pack_rows_match_c_enum():
    names = _c_enum("Row")
    assert names[-1] == "R_COUNT"
    assert names[:-1] == [f"R_{n.upper()}" for n in cc.pack_rows()]


@pytest.mark.parametrize("config", [(1, 2, 1, 1), (2, 1, 1, 1), (2, 2, 2, 1),
                                    (2, 2, 1, 2)])
def test_kernel_refuses_non_default_config(params, plain_fp64_100, config):
    """Every scheme version is taken now: a single alternate's configuration
    passes the configuration check and, on a CPU pack, stops only at the
    CUDA-device check; its build differs from the reference's."""
    _, p, _, _ = plain_fp64_100
    c = tscheme.derived_consts(params, 3600.0, torch.float64,
                               tscheme.SchemeConfig(*config))
    cc.check_kernel_config(c)
    with pytest.raises(ValueError, match="CUDA device"):
        cc.check_kernel_args(p, c)
    v = cc.kernel_version(c)
    assert (v.iwarmrain, v.ievaprain, v.ievapsnow, v.idepice) == config
    assert v != cc.DEFAULT_VERSION


def test_kernel_refuses_other_arguments(params, plain_fp64_100):
    _, p, c, _ = plain_fp64_100
    # the reference configuration on a CPU tensor: not a CUDA device
    with pytest.raises(ValueError, match="CUDA device"):
        cc.check_kernel_args(p, c)
    c32 = tscheme.derived_consts(params, 3600.0, torch.float32)
    with pytest.raises(ValueError, match="fp32/fp64"):
        cc.check_kernel_args(p, c32)
    # dynamic_skips=False is a build of its own now: taken, and stopped on
    # a CPU pack only by the device check
    nodyn = tscheme.derived_consts(params, 3600.0, torch.float64,
                                   tscheme.SchemeConfig(dynamic_skips=False))
    with pytest.raises(ValueError, match="CUDA device"):
        cc.check_kernel_args(p, nodyn)
    assert not cc.kernel_version(nodyn, p.form).dynamic_skips
    with pytest.raises(ValueError, match="skip tags"):
        cc.check_kernel_config(tscheme.derived_consts(
            params, 3600.0, torch.float64, tscheme.SchemeConfig(skip=("s99",))))
    with pytest.raises(ValueError, match="1\\|2"):
        cc.check_kernel_config(tscheme.derived_consts(
            params, 3600.0, torch.float64, tscheme.SchemeConfig(iwarmrain=3)))
    bad = cc.FoldedPack(pack=p.pack, col=p.col, rows=p.rows[:-1], fn=True)
    with pytest.raises(ValueError, match="layout"):
        cc.check_kernel_args(bad, c)
    # the in-line CUADJTQ form is taken too: its pack passes the layout
    # check, and a pack that claims a form its rows are not is refused
    inline = cc.FoldedPack(pack=p.pack[:, :-1].contiguous(), col=p.col,
                           rows=cc.pack_rows(fn=False), fn=False)
    with pytest.raises(ValueError, match="CUDA device"):
        cc.check_kernel_args(inline, c)
    assert not cc.kernel_version(c, inline.form).fn
    liar = cc.FoldedPack(pack=p.pack, col=p.col, rows=p.rows, fn=True,
                         fc=True)
    with pytest.raises(ValueError, match="layout"):
        cc.check_kernel_args(liar, c)


def test_parse_ptxas():
    text = (
        "ptxas info    : Compiling entry function "
        "'_ZN7cloudsc12fused_kernelIfEEvPKT_S3_PKdPS1_S6_S6_iii' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN7cloudsc12fused_kernelIfEE\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 376 bytes smem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN7cloudsc12fused_kernelIdEEvPKT_S3_PKdPS1_S6_S6_iii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers, 752 bytes smem\n"
    )
    info = build.parse_ptxas(text)
    assert info["fused_f32"] == dict(stack=8, spill_stores=4, spill_loads=4,
                                     registers=168)
    assert info["fused_f64"]["registers"] == 255
    assert info["fused_f64"]["spill_stores"] == 0


def test_parse_ptxas_keeps_each_kernel_apart():
    """A second kernel templated on the dtype (the floor body) and the
    probes' kernels do not overwrite K1's entry, nor do the properties of a
    device function it calls, which ptxas prints after it."""
    text = (
        "ptxas info    : Compiling entry function "
        "'_ZN7cloudsc12fused_kernelIfEEvPKT_S3_PKdPS1_S6_S6_iii' for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 376 bytes smem\n"
        "ptxas info    : Function properties for __internal_accurate_pow\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Compiling entry function "
        "'_ZN7cloudsc12floor_kernelIfEEvPKT_S3_PKdPS1_S6_S6_iii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 18 registers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN7cloudsc11init_kernelIdEEvPKT_S3_PKdPS1_S6_S6_iii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 90 registers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN6probes14overlap_kernelILi3ELi8EEEvPKfPfS3_S2_S3_iiii' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 56 registers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN6probes11copy_kernelEPKfPfS1_S2_iixixx' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 24 registers\n"
    )
    info = build.parse_ptxas(text)
    assert sorted(info) == ["copy", "floor_f32", "fused_f32", "init_f64",
                            "overlap_3_8"]
    assert info["fused_f32"] == dict(stack=8, spill_stores=8, spill_loads=8,
                                     registers=168)
    assert info["floor_f32"]["registers"] == 18
    assert info["init_f64"]["registers"] == 90
    assert build.ptxas_summary(info)[0].startswith("fused_f32: 168 registers")


def test_every_entry_point_is_declared():
    """Each `extern "C"` function of csrc/*.cu has its argument types in
    build.ENTRY_POINTS, one per parameter."""
    decl = {}
    for path in sorted(build.CSRC.glob("*.cu")):
        src = path.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
            decl[m.group(1)] = len(m.group(2).split(","))
        for m in re.finditer(r"CLOUDSC_ENTRY\((\w+),", src):
            decl[m.group(1)] = 10
    decl.pop("NAME", None)
    assert {k: len(v) for k, v in build.ENTRY_POINTS.items()} == decl


def test_occupancy_entry_points_are_declared():
    """K1's occupancy query, one per precision, takes one pointer (int
    out[7]) and is declared so in the source."""
    src = (build.CSRC / "cloudsc_fused.cu").read_text()
    for t in ("f32", "f64"):
        name = f"cloudsc_fused_occupancy_{t}"
        assert build.ENTRY_POINTS[name] == [ctypes.c_void_p]
        assert re.search(r'extern "C" int %s\(int\* out\)' % name, src)
    assert len(cc.OCCUPANCY_KEYS) == 7


def test_ring_geometry_reaches_the_source():
    """One geometry both read: `cuda_cloudsc.RING` becomes the build's
    CLOUDSC_RING_* macros, which the source requires and reads."""
    flags = build.nvcc_flags()
    src = (build.CSRC / "cloudsc_fused.cu").read_text()
    assert "#error" in src
    g = cc.RING
    for key, value in (("STAGES", g.stages), ("BLOCK", g.block),
                       ("MIN_BLOCKS", g.min_blocks)):
        macro = f"CLOUDSC_RING_{key}"
        assert f"-D{macro}={value}" in flags
        assert src.count(macro) == 2, macro  # the guard and the read
    assert g.stages >= 3 and g.block % 32 == 0
    for size in (4, 8):
        assert g.smem_bytes(size) == g.stages * 19 * g.block * size
    other = cc.RingGeometry(5, 64, 2)
    assert build.source_hash(build.nvcc_flags(other)) != \
        build.source_hash(flags)


def _replay_ring(ops, nlev, stages):
    """Replays a ring schedule (`cuda_cloudsc.ring_schedule`'s form) and
    returns the faults found: a stage overwritten before the last read of
    the level it holds, a read of a level the stage does not hold or whose
    copy group is not complete under the waits so far, a group that does
    not hold its own level, a level not copied or not read."""
    faults = []
    groups, open_copies, complete, holds = [], [], 0, {}
    last_read = {op[1]: i for i, op in enumerate(ops) if op[0] == "read"}
    for i, op in enumerate(ops):
        if op[0] == "copy":
            _, lev, s = op
            if s != lev % stages:
                faults.append(f"level {lev} copied to stage {s}")
            if s in holds and last_read.get(holds[s][0], -1) > i:
                faults.append(f"stage {s} overwritten by level {lev} before "
                              f"the last read of level {holds[s][0]}")
            holds[s] = (lev, len(groups))
            open_copies.append(lev)
        elif op[0] == "commit":
            groups.append(open_copies)
            open_copies = []
        elif op[0] == "wait":
            complete = max(complete, len(groups) - op[1])
        elif op[0] == "read":
            _, lev, s = op
            if s not in holds or holds[s][0] != lev:
                faults.append(f"level {lev} read from stage {s}, which holds "
                              f"{holds.get(s)}")
            elif holds[s][1] >= complete:
                faults.append(f"level {lev} read before its group completed")
    for g, levs in enumerate(groups):
        if levs != ([g] if g <= nlev else []):
            faults.append(f"group {g} holds levels {levs}")
    if open_copies:
        faults.append("copies never committed")
    if set(last_read) != set(range(nlev + 1)):
        faults.append("not every level is read")
    return faults


@pytest.mark.parametrize("nlev", [137, 5])
@pytest.mark.parametrize("stages", sorted({3, 4, 5, cc.RING.stages}))
def test_ring_schedule_is_safe(nlev, stages):
    """Under wait_group(S-2) levels k and k+1 are complete when level k
    reads them, and no stage is overwritten before its last reader; S-2
    later levels stay in flight while level k computes."""
    ops = cc.ring_schedule(nlev, stages)
    assert _replay_ring(ops, nlev, stages) == []
    assert sum(op[0] == "copy" for op in ops) == nlev + 1
    assert {op[1] for op in ops if op[0] == "wait"} == {stages - 2, 0}
    # copied by the time level k reads its rows: levels up to k+S-1
    k = nlev // 2
    i = ops.index(("read", k + 1, (k + 1) % stages),
                  ops.index(("read", k, k % stages)) + 1)
    copied = [op[1] for op in ops[:i] if op[0] == "copy"]
    assert max(copied) == min(k + stages - 1, nlev)


def test_ring_replay_finds_faults():
    """The replay has teeth: a wait one group short, a copy one level too
    far ahead, and a read from the wrong stage are each found."""
    nlev, stages = 7, 4
    ops = cc.ring_schedule(nlev, stages)
    short = [("wait", stages - 1) if op == ("wait", stages - 2) else op
             for op in ops]
    assert any("before its group" in f
               for f in _replay_ring(short, nlev, stages))
    ahead = []
    for op in ops:
        if op[0] == "copy" and op[1] >= stages - 1:
            op = ("copy", op[1] + 1, (op[1] + 1) % stages)
        ahead.append(op)
    assert any("overwritten" in f for f in _replay_ring(ahead, nlev, stages))
    wrong = [("read", op[1], (op[2] + 1) % stages) if op[0] == "read" else op
             for op in ops]
    assert any("which holds" in f for f in _replay_ring(wrong, nlev, stages))


_STUB_CUDA_RUNTIME = """#pragma once
#include <cmath>
#include <math.h>
#define __device__
#define __host__
#define __forceinline__ inline
"""


def _host_harness(p, c, version, tmp_path, *mode):
    """tests/cpu_scheme_harness.cpp built with g++ -ffp-contract=off,
    `version`'s CLOUDSC_* macros and the working type of pack `p` (a stub
    cuda_runtime.h in `tmp_path`), run on `p` and constants `c` in `mode`
    (none: the level loop, or "zdqs"); returns the float64 values it
    wrote."""
    import subprocess

    gxx = shutil.which("g++")
    exe = tmp_path / "harness"
    (tmp_path / "cuda_runtime.h").write_text(_STUB_CUDA_RUNTIME)
    t = "float" if p.pack.dtype == torch.float32 else "double"
    r = subprocess.run(
        [gxx, "-O1", "-std=c++17", "-ffp-contract=off", f"-I{tmp_path}",
         f"-I{build.CSRC}", *version.macros(), f"-DHARNESS_T={t}", "-o",
         str(exe), str(Path(__file__).with_name("cpu_scheme_harness.cpp"))],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    p.pack.double().numpy().tofile(tmp_path / "pack.bin")
    p.col.double().numpy().tofile(tmp_path / "col.bin")
    cc.const_vector(c).numpy().tofile(tmp_path / "consts.bin")
    r = subprocess.run([str(exe), str(p.nlev), str(p.ncol), str(len(p.rows)),
                        str(tmp_path), *mode], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    out = tmp_path / ("zdqs.bin" if mode else "out.bin")
    return torch.from_numpy(np.fromfile(out, np.float64))


def host_harness_outputs(p, c, version, tmp_path):
    """The host-compiled scheme header's level loop (`_host_harness`) on
    pack `p`: its outputs after `assemble`, in the pack's dtype."""
    raw = _host_harness(p, c, version, tmp_path).to(p.pack.dtype)
    nl, n = p.nlev, p.ncol
    fo = version.fold_outputs
    sizes = (nl * len(cc.OLEV_ROWS) * n,
             (nl + 1) * len(cc.ohalf_rows(fo)) * n, n)
    lev, half, pr = raw.split(sizes)
    return cc.assemble((lev.reshape(nl, -1, n), half.reshape(nl + 1, -1, n),
                        pr), p, c, fo)


def host_harness_zdqs(p, c, version, tmp_path):
    """The host-compiled header's `level_zdqs` (zdqs_kernel's element) for
    every (level, column) of pack `p`: the `(nlev, ncol)` ZDQS row in the
    pack's dtype."""
    return _host_harness(p, c, version, tmp_path, "zdqs").to(
        p.pack.dtype).reshape(p.nlev, p.ncol)


@pytest.mark.parametrize("case", ["reference", *synthetic.VERSION_CASES])
def test_scheme_header_matches_plain_on_cpu(case, tmp_path):
    """csrc/cloudsc_scheme.cuh compiled for the host (tests/
    cpu_scheme_harness.cpp: fused_kernel's level loop without the ring, g++
    -ffp-contract=off, the version's CLOUDSC_* macros) against the plain
    version on the same 100-column fp64 pack, within test_golden's FP64_TOL
    per field (the host libm and torch's CPU kernels differ by ulps;
    measured 1.1e-15). Each scheme version's branches and constants are
    held on a host without a card: a wrong constant in any of the alternate
    branches moves a field by 1e-6 to 0.6 of its sum. The forms' macros are
    held the same way in test_torch_probe.py."""
    from cloudsc_tpu_torch.physics.cloudsc import CloudscOutputs

    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    inp = _inp(100)
    params = Params.from_input(inp)
    cfg = tscheme.SchemeConfig()
    if case != "reference":
        inp, params, cfg = synthetic.version_case(case, inp, params)
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float64, cfg)
    p = cc.pack_inputs_folded(inp, params, cfg, dtype=torch.float64)
    got = host_harness_outputs(p, c, cc.kernel_version(c), tmp_path)
    want = cc.assemble(cc.cloudsc_fused_plain(p, c), p, c)
    bad = {name: relerr(getattr(got, name).numpy(), getattr(want, name).numpy())
           for name in CloudscOutputs._fields
           if not relerr(getattr(got, name).numpy(),
                         getattr(want, name).numpy()) < FP64_TOL}
    assert not bad, f"{case}: the host-compiled scheme header vs plain: {bad}"


def _dict_pack(ncol, dtype):
    """(params, derived_consts, the unfolded pack of `make_inputs`' field
    dict at `ncol` columns, the dict): what a field dict's build reads."""
    from cloudsc_tpu_torch import data as tdata
    from cloudsc_tpu_torch.params import Params as TParams
    from cloudsc_tpu_torch.physics.cloudsc import make_inputs as tmake

    inp = tdata.load_input(tdata.default_input_path(), ncol)
    params = TParams.from_input(inp)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    fields = tmake(inp, dtype)
    return params, c, cc.pack_inputs(fields, params), fields


def _with_zdqs(p, zdqs):
    """Unfolded pack `p` with the ZDQS row `zdqs` (nlev, ncol) in its
    place (its edge row nlev replicated): the rows of a field dict's
    build (`cuda_cloudsc.ROWS_FORM`)."""
    rows = cc.pack_rows(aer=p.rows[len(cc.UNFOLDED_ROWS):], fold_inputs=False)
    i = rows.index(cc.ZDQS_ROW)
    z = torch.cat([zdqs, zdqs[-1:]])[:, None]
    pack = torch.cat([p.pack[:, :i], z, p.pack[:, i:]], dim=1).contiguous()
    return cc.FoldedPack(pack=pack, col=p.col, rows=rows, fn=True,
                         fold_inputs=False)


@pytest.mark.parametrize("ncol", [37, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["fp32", "fp64"])
def test_header_zdqs_row_is_the_inline_chain(dtype, ncol, tmp_path):
    """The host-compiled header in both precisions (tests/
    cpu_scheme_harness.cpp): `level_zdqs` for every (level, column) — what
    zdqs_kernel computes — is the in-line CUADJTQ bit for bit: the dict
    build's level loop (CLOUDSC_FN beside the unfolded rows) streaming that
    row gives the in-line build's 21 outputs bit for bit, so K1 reads
    none of its levels above the cloud top, which are 0 in it and in
    `zdqs_plain`'s. Below, the row is `zdqs_plain`'s within 256 units of
    the working precision's epsilon (errsum/refsum, FP64_TOL's scale: the
    host libm and torch's CPU exponentials differ by ulps, which the
    subtraction ZDQS = qloc - ZQSMIX magnifies; measured 1.8e-14 on one
    fp64 level), over all those levels and the last (PMF of the level below
    masked) each; the fp64 build's outputs are the plain version's on the
    same pack within FP64_TOL."""
    from cloudsc_tpu_torch.physics.cloudsc import CloudscOutputs

    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    _, c, p, fields = _dict_pack(ncol, dtype)
    inline = cc.KernelVersion(fold_inputs=False, fn=False)
    rows = cc.kernel_version(c, cc.ROWS_FORM)
    assert (rows.fold_inputs, rows.fn) == (False, True)
    zdqs = host_harness_zdqs(p, c, inline, tmp_path)
    want = host_harness_outputs(p, c, inline, tmp_path)
    q = _with_zdqs(p, zdqs)
    got = host_harness_outputs(q, c, rows, tmp_path)
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    for name in CloudscOutputs._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a.view(ints), b.view(ints)), name
    plain = cc.zdqs_plain(fields, c)
    tol = 256 * torch.finfo(dtype).eps
    ktop = c.NCLDTOP - 1
    assert bool(torch.isfinite(zdqs).all())
    assert not bool(zdqs[:ktop].any()) and not bool(plain[:ktop].any())
    for part in (slice(ktop, None), slice(-1, None)):
        err = relerr(zdqs[part].numpy(), plain[part].numpy())
        assert err < tol, (part, err)
    if dtype == torch.float64:
        ref = cc.assemble(cc.cloudsc_fused_plain(q, c), q, c)
        bad = {n: relerr(getattr(got, n).numpy(), getattr(ref, n).numpy())
               for n in CloudscOutputs._fields
               if not relerr(getattr(got, n).numpy(),
                             getattr(ref, n).numpy()) < FP64_TOL}
        assert not bad, bad


# an H100 SM's shared memory (228 KB) and the 1 KB the runtime keeps of it
# for each resident block (CUDA C++ Programming Guide, compute capability
# 9.0)
SM_SMEM_BYTES, BLOCK_SMEM_RESERVE = 233472, 1024


@pytest.mark.parametrize("form", ["main", "unfolded", "rows"])
@pytest.mark.parametrize("itemsize,blocks", [(4, 3), (8, 2)],
                         ids=["fp32", "fp64"])
def test_ring_keeps_its_blocks_an_sm(form, itemsize, blocks):
    """K1's ring at the rows of the main path (19), the unfolded pack (27)
    and a field dict's build (28, the ZDQS row beside the fields) fits the
    blocks an SM that the builds run with in shared memory: 3 in fp32 (its
    registers allow no more), 2 in fp64, the launch bound's. Each block
    holds the ring (`RingGeometry.smem_bytes`), the constants cast to the
    working type (static) and the runtime's reserve; the ring's schedule
    does not depend on the rows (`ring_schedule`)."""
    g = cc.RING
    nrows = len({"main": cc.pack_rows(),
                 "unfolded": cc.pack_rows(fn=False, fold_inputs=False),
                 "rows": cc.pack_rows(fold_inputs=False)}[form])
    assert nrows == {"main": 19, "unfolded": 27, "rows": 28}[form]
    per_block = g.smem_bytes(itemsize, nrows) \
        + itemsize * len(cc.CONST_NAMES) + BLOCK_SMEM_RESERVE
    assert SM_SMEM_BYTES // per_block >= max(blocks, g.min_blocks)
    assert _replay_ring(cc.ring_schedule(137, g.stages), 137, g.stages) == []
