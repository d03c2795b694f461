"""K1's output rows on the CPU (CLOUDSC_FOLD_OUTPUTS): the build that writes
the four derivable flux rows itself against the one that leaves them to
`assemble`, on the folded pack, the unfolded pack and the per-field entry.

  * foldo off against foldo on, fp64 and fp32: every field bit for bit but
    PFSQLTUR/PFSQITUR, which are held at the JAX test's atol 1e-12
    (tests/test_fold_outputs.py; the port's kernel and plain version add
    the running sums in the synthesis's order, so they come out bit for
    bit too, and that is checked);
  * the synthesised running sums are the exact sequential recurrence
    (acc + pvfl*ptsphy*zgdph_r, level by level), and PFHPSL/N the single
    multiply;
  * the drop list and the buffer's rows are the JAX module's;
  * the driver reads CLOUDSC_FOLD_OUTPUTS once and runs the build it names;
  * the flux rows' kernel (csrc/foldo.cu, tested on the card in
    tests/test_torch_cuda.py): on the CPU `foldo_synthesize` is its plain
    loop, bit for bit and with the loop's operation count; the wrapper's
    checks refuse what the kernel does not take; its C entry points are
    declared with pointer argument types.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from cloudsc_tpu.data import load_input
from cloudsc_tpu.kernels import pallas_cloudsc as pc
from cloudsc_tpu_torch.kernels import build
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.physics import cloudsc as tcloudsc
from cloudsc_tpu_torch.physics import scheme as tscheme
from cloudsc_tpu_torch.runtime import tracing

from conftest import REFERENCE_DATA

torch.set_num_threads(1)

TUR_ATOL = 1e-12  # tests/test_fold_outputs.py
TUR = ("pfsqltur", "pfsqitur")


def _inp(ngptot=100):
    return load_input(REFERENCE_DATA, ngptot=ngptot, expand=False)


def _payload(kind, inp, params, dtype):
    if kind == "fields":
        return tcloudsc.make_inputs(inp, dtype)
    return cc.pack_inputs_raw(inp, params, dtype=dtype, column_order="cyclic",
                              fold_inputs=kind == "folded",
                              fn=kind == "folded")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["folded", "unfolded", "fields"])
def test_foldo_off_matches_on(params, kind, dtype):
    inp = _inp()
    tdt = getattr(torch, dtype)
    src = _payload(kind, inp, params, tdt)
    p = src if kind != "fields" else cc.pack_inputs(src, params)
    c = tscheme.derived_consts(params, inp.ptsphy, tdt)
    res = {}
    for fo in (True, False):
        raw = cc.cloudsc_fused(p, c, fold_outputs=fo)
        assert raw[1].shape[1] == len(cc.ohalf_rows(fo)) == (10 if fo else 14)
        res[fo] = cc.assemble(raw, src, c, fo)
    if kind == "fields":
        entry = cc.cloudsc_fused_fields(src, params, inp.ptsphy,
                                        fold_outputs=False)
        for name, a, b in zip(entry._fields, entry, res[False]):
            assert torch.equal(a, b), name
    for name, a, b in zip(res[True]._fields, res[False], res[True]):
        if name in TUR:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=TUR_ATOL, err_msg=name)
        # the same recurrence in the same order: bit for bit
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_synthesised_rows_are_the_sequential_recurrence(params, dtype):
    """PFSQLTUR/ITUR: acc(0) = 0, acc(k+1) = acc(k) + (pvfl*ptsphy)*zgdph_r
    in the working precision, one level after another (numpy, a Python
    loop); PFHPSL/N: -RLVTT/RLSTT x PFPLSL/N."""
    inp = _inp()
    tdt = getattr(torch, dtype)
    ndt = np.dtype(dtype).type
    p = _payload("folded", inp, params, tdt)
    c = tscheme.derived_consts(params, inp.ptsphy, tdt)
    half = {"pfplsl": torch.linspace(0, 1, (p.nlev + 1) * p.ncol,
                                     dtype=tdt).reshape(p.nlev + 1, -1)}
    half["pfplsn"] = 2 * half["pfplsl"]
    cc.foldo_synthesize(half, p, c)
    paph = p.pack[:, p.row("paph")].numpy()
    zgdph_r = ndt(-c.zrg_r) * (paph[1:] - paph[:-1]) * ndt(c.zqtmst)
    for name, row in (("pfsqltur", "pvfl"), ("pfsqitur", "pvfi")):
        term = p.pack[:p.nlev, p.row(row)].numpy() * ndt(c.ptsphy) * zgdph_r
        acc = np.zeros(p.ncol, dtype)
        want = [acc]
        for k in range(p.nlev):
            acc = acc + term[k]
            want.append(acc)
        np.testing.assert_array_equal(half[name].numpy(), np.stack(want),
                                      err_msg=name)
    np.testing.assert_array_equal(
        half["pfhpsl"].numpy(), ndt(-c.RLVTT) * half["pfplsl"].numpy())
    np.testing.assert_array_equal(
        half["pfhpsn"].numpy(), ndt(-c.RLSTT) * half["pfplsn"].numpy())


def test_drop_list_and_rows_are_the_jax_modules():
    assert cc.FOLDO_DROP == pc._FOLDO_DROP
    assert cc.ohalf_rows(True) == pc._ohalf_rows(True)
    assert set(cc.ohalf_rows(False)) == set(pc._OHALF_ROWS)
    assert cc.ohalf_rows(False)[:10] == cc.OHALF_ROWS
    v = cc.KernelVersion(fold_outputs=False)
    assert "-DCLOUDSC_FOLD_OUTPUTS=0" in v.macros()
    assert "-DCLOUDSC_FOLD_OUTPUTS=1" in cc.DEFAULT_VERSION.macros()
    assert cc.CONST_NAMES[-1] == "RLVTT"


def test_driver_fold_outputs_switch(params, monkeypatch):
    """CLOUDSC_FOLD_OUTPUTS=0, read once at construction: the build that
    writes the rows (its own KernelVersion), the name `+foldo0`, and the
    same outputs as the default bit for bit."""
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    for var in ("CLOUDSC_FOLD_OUTPUTS", "CLOUDSC_FOLD_INPUTS",
                "CLOUDSC_PACKED_STORAGE"):
        monkeypatch.delenv(var, raising=False)
    inp = _inp(128)
    base, _, _ = CloudscDriver(params, inp.ptsphy, torch.float32,
                               "cpu").run(inp)
    monkeypatch.setenv("CLOUDSC_FOLD_OUTPUTS", "0")
    d = CloudscDriver(params, inp.ptsphy, torch.float32, "cpu")
    monkeypatch.setenv("CLOUDSC_FOLD_OUTPUTS", "1")  # read once, above
    assert not d.fold_outputs and not d.step.fold_outputs
    assert d.config_name("cuda") == "cuda/grouped+fold+foldo0+fn"
    p = d.prepare(inp)
    v = cc.kernel_version(d.step.c, p.form, d.fold_outputs)
    assert not v.fold_outputs and v != cc.DEFAULT_VERSION
    assert d.step(p)[1].shape[1] == 14
    out, _, _ = d.run(inp)
    for name, a, b in zip(base._fields, out, base):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["folded", "fields"])
def test_cpu_foldo_is_the_plain_loop(params, kind, dtype):
    """On CPU tensors `foldo_synthesize` runs the plain loop: the same four
    rows bit for bit, its 559 operations at 137 levels, no launch."""
    inp = _inp()
    tdt = getattr(torch, dtype)
    src = _payload(kind, inp, params, tdt)
    p = src if kind != "fields" else cc.pack_inputs(src, params)
    c = tscheme.derived_consts(params, inp.ptsphy, tdt)
    o_half = cc.cloudsc_fused(p, c)[1]
    half = {n: o_half[:, j] for j, n in enumerate(cc.ohalf_rows(True))}
    got, want = dict(half), dict(half)
    before = (tracing.counter("ops.assemble"),
              tracing.counter("launches.foldo"))
    cc.foldo_synthesize(got, src, c)
    assert (tracing.counter("ops.assemble") - before[0],
            tracing.counter("launches.foldo") - before[1]) == \
        (5 + 2 * (3 + 2 * 137), 0) == (559, 0)
    cc.foldo_synthesize_plain(want, src, c)
    for name in cc.FOLDO_ROWS:
        assert torch.equal(got[name], want[name]), name


def _foldo_rows(dtype=torch.float64, nlev=6, ncol=9):
    """(paph, pvfl, pvfi, pfplsl, pfplsn) of the shapes the kernel takes,
    the last two strided views of one buffer as K1's o_half gives them."""
    gen = torch.Generator().manual_seed(3)
    paph = torch.rand(nlev + 1, ncol, generator=gen, dtype=dtype)
    pvfl, pvfi = torch.rand(2, nlev, ncol, generator=gen, dtype=dtype)
    o_half = torch.rand(nlev + 1, 3, ncol, generator=gen, dtype=dtype)
    return [paph, pvfl, pvfi, o_half[:, 0], o_half[:, 2]]


def _transposed(rows):
    rows[1] = rows[1].t().contiguous().t()   # (nlev, ncol), column stride nlev
    return rows


@pytest.mark.parametrize("case, edit, match", [
    ("column_stride", _transposed, "columns must be contiguous"),
    ("pvfi_levels", lambda r: r[:2] + [torch.cat([r[2], r[2][:1]])]
     + r[3:], r"pvfi \(7, 9\): expected \(6, 9\)"),
    ("pfplsn_columns", lambda r: r[:4] + [r[4][:, :8]],
     r"pfplsn \(7, 8\): expected \(7, 9\)"),
    ("paph_ndim", lambda r: [r[0][None]] + r[1:], "expected"),
    ("fp16", lambda r: [x.half() for x in r], "one type, fp32 or fp64"),
    ("mixed_types", lambda r: r[:3] + [r[3].float()] + r[4:],
     "one type, fp32 or fp64"),
    ("cpu", lambda r: r, "one CUDA device"),
])
def test_foldo_checks_refuse(case, edit, match):
    """`check_foldo_args` raises on what csrc/foldo.cu does not take: a
    non-unit column stride, rows whose shapes do not match, another type
    or mixed types, and rows off the card (so on this CPU every set of
    rows ends in a refusal, sound rows in the device's)."""
    rows = edit(_foldo_rows())
    with pytest.raises(ValueError, match=match):
        cc.check_foldo_args(*rows)


@pytest.mark.parametrize("t, ctype", [("f32", "float"), ("f64", "double")])
def test_foldo_entry_points_are_declared(t, ctype):
    """cloudsc_foldo_{f32,f64}: five row pointers, their five level
    strides as 64-bit integers, the output pointer, nlev and ncol, five
    constants as doubles and the stream, as csrc/foldo.cu declares them."""
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    assert build.ENTRY_POINTS[f"cloudsc_foldo_{t}"] == \
        [vp] * 5 + [ll] * 5 + [vp, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_double] * 5 + [vp]
    src = (build.CSRC / "foldo.cu").read_text()
    m = re.search(r'extern "C" int cloudsc_foldo_%s\(([^)]*)\)' % t, src)
    params = [" ".join(a.split()) for a in m.group(1).split(",")]
    assert params[:5] == [f"const {ctype}* {n}" for n in
                          ("paph", "pvfl", "pvfi", "pfplsl", "pfplsn")]
    assert params[10] == f"{ctype}* out" and params[-1] == "void* stream"
    assert all(a.startswith("long long") for a in params[5:10])
    assert all(a.startswith("double") for a in params[13:18])


def test_foldo_source_builds_only_alone():
    """csrc/foldo.cu builds into its own library alone: the default
    build's sources and hash leave it out, and its own library's entry
    points are the two that `ALONE` names, declared in ENTRY_POINTS."""
    foldo = build.CSRC / "foldo.cu"
    assert foldo not in build._sources()
    assert build._sources([foldo]) == [foldo]
    flags = build.nvcc_flags()
    assert build.source_hash(flags, [foldo]) != build.source_hash(flags)
    names = build.ALONE["foldo.cu"]
    assert set(names) == {n for n in build.ENTRY_POINTS
                          if n.startswith("cloudsc_foldo_")}
    src = foldo.read_text()
    assert all(f'extern "C" int {n}(' in src for n in names)
