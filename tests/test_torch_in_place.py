"""K1 reading a plain field dict in place, on the CPU: the layout check
(`rows_in_place`), the row table the Rows policy of csrc/cloudsc_fused.cu
reads (`row_table`), its clamp rule against the device pack it replaces
(`pack_inputs`), the plain version reading the dict through that table,
and the ptxas keys of the two policies' builds. The launch itself needs a
card (`tests/test_torch_cuda.py`).

  * `rows_in_place` takes `physics.cloudsc.make_inputs`' dict and
    `cellbench.inputs.field_dict`'s, fp32 and fp64, for the reference
    configuration and the aerosol build (its five extra rows), and refuses
    a transposed or sliced row, a wrong dtype, and flags that are not bool
    and int32;
  * the row table names the unfolded pack's rows in its order, each its
    field's own tensor, of height nlev (nlev+1 for PAPH);
  * reading row r of level lev at level min(lev, h_r - 1), as the kernel
    does, rebuilds `pack_inputs(fields).pack` bit for bit, and the flags in
    their own dtypes read as the pack's `col` does;
  * on the CPU the step reads the dict through its row table and the ZDQS
    row `zdqs_plain` makes of it, and packs nothing (`ops.pack` 0), its
    outputs bit for bit the plain version's on `pack_inputs(fields)` (the
    in-line CUADJTQ), for the reference configuration and the aerosol
    build, at a whole and a ragged column count; `cloudsc_fused`,
    `zdqs_row` and the step refuse a dict that `rows_in_place` refuses,
    naming the row, and a dict with a diagnostic body;
  * `zdqs_plain` is the in-line chain of `scheme.level_step` bit for bit
    on every level it runs, its last level masks the PMF of the level
    below, and the levels above the cloud top, which K1 never reads, are
    0;
  * the step's TENDENCY_LOC_CLD is a view of K1's level buffer, its
    vapour plane exactly 0, bit for bit the four cloud species' rows
    stacked with a zero plane, in both precisions, with and without the
    folded-out flux rows.
"""

import pytest
import torch

from cellbench import inputs as cbinputs
from cloudsc_tpu_torch import data as tdata
from cloudsc_tpu_torch.data import synthetic
from cloudsc_tpu_torch.kernels import build
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.params import Params
from cloudsc_tpu_torch.physics import scheme as tscheme
from cloudsc_tpu_torch.physics.cloudsc import make_inputs
from cloudsc_tpu_torch.runtime import tracing

torch.set_num_threads(1)

NCOL = 256
DTYPES = {"fp32": torch.float32, "fp64": torch.float64}


def _case(case, dtype, source="make_inputs", ncol=NCOL):
    """(inp, params, SchemeConfig or None, derived_consts, field dict) of
    the reference configuration or the aerosol build, the dict from
    `make_inputs` or `cellbench.inputs.field_dict`."""
    inp = tdata.load_input(tdata.default_input_path(), ncol)
    params = Params.from_input(inp)
    config = None
    if case == "aerosol":
        inp, params, config = synthetic.version_case(case, inp, params)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype, config)
    if source == "make_inputs":
        fields = make_inputs(inp, dtype)
    else:
        snap, _ = cbinputs.load_snapshot()
        precision = next(k for k, v in DTYPES.items() if v == dtype)
        fields = cbinputs.field_dict(snap, ncol, precision, "cpu")
    return inp, params, config, c, fields


@pytest.mark.parametrize("source", ["make_inputs", "field_dict"])
@pytest.mark.parametrize("case", ["reference", "aerosol"])
@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_rows_in_place_takes_the_plain_dicts(precision, case, source):
    *_, c, fields = _case(case, DTYPES[precision], source)
    assert len(cc.aer_rows(c)) == (5 if case == "aerosol" else 0)
    assert cc.rows_in_place(fields, c)


def _faults():
    nlev = 137
    return {
        "transposed": lambda f, dt: {**f, "pq": f["pq"].t().contiguous().t()},
        "sliced_columns": lambda f, dt: {**f, "pa": f["pa"][:, :-1]},
        "sliced_levels": lambda f, dt: {**f, "paph": f["paph"][:nlev]},
        "strided_species": lambda f, dt: {
            **f, "pclv": f["pclv"].transpose(1, 2).contiguous()
            .transpose(1, 2)},
        "wrong_dtype": lambda f, dt: {
            **f, "pvfl": f["pvfl"].to(torch.float64 if dt == torch.float32
                                      else torch.float32)},
        "plsm_dtype": lambda f, dt: {
            **f, "plsm": f["plsm"].to(torch.float64 if dt == torch.float32
                                      else torch.float32)},
        "ldcum_not_bool": lambda f, dt: {**f, "ldcum": f["ldcum"].to(dt)},
        "ktype_not_int32": lambda f, dt: {
            **f, "ktype": f["ktype"].to(torch.int64)},
        "missing_row": lambda f, dt: {k: v for k, v in f.items()
                                      if k != "psupsat"},
    }


# the row each fault names in the refusal
NAMED = {"transposed": "pq", "sliced_columns": "pa", "sliced_levels": "paph",
         "strided_species": "pclv0", "wrong_dtype": "pvfl",
         "plsm_dtype": "plsm", "ldcum_not_bool": "ldcum",
         "ktype_not_int32": "ktype", "missing_row": "psupsat"}


@pytest.mark.parametrize("fault", list(_faults()))
def test_rows_in_place_refuses(fault):
    """`cloudsc_fused` and the step raise on a dict `rows_in_place`
    refuses, naming the row; nothing is packed or run."""
    dtype = torch.float32
    inp, params, _, c, fields = _case("reference", dtype)
    bad = _faults()[fault](fields, dtype)
    assert not cc.rows_in_place(bad, c)
    tracing.reset()
    with pytest.raises(ValueError, match=f"in place: .*{NAMED[fault]}"):
        cc.cloudsc_fused(bad, c)
    with pytest.raises(ValueError, match=f"in place: .*{NAMED[fault]}"):
        cc.zdqs_row(bad, c)
    with pytest.raises(ValueError, match=f"in place: .*{NAMED[fault]}"):
        cc.FusedStep(params, inp.ptsphy, dtype)(bad)
    assert tracing.counter("ops.pack") == tracing.counter("pack_bytes") == 0


@pytest.mark.parametrize("mode", ["floor", "init"])
def test_a_dict_runs_the_full_body_only(mode):
    """The diagnostic bodies read a pack: on a dict they raise."""
    *_, c, fields = _case("reference", torch.float64, ncol=8)
    with pytest.raises(ValueError, match="full body"):
        cc.cloudsc_fused(fields, c, mode=mode)


@pytest.mark.parametrize("case", ["reference", "aerosol"])
def test_row_table_is_the_unfolded_pack_rows(case):
    inp, *_, c, fields = _case(case, torch.float64)
    table = cc.row_table(fields, c)
    names = [n for n, _ in table]
    assert tuple(names) == cc.pack_rows(fn=False, aer=cc.aer_rows(c),
                                        fold_inputs=False)
    for name, t in table:
        field, m = cc._unfolded_source(name)
        src = fields[field] if m is None else fields[field][m]
        assert t.data_ptr() == src.data_ptr() and t.shape == src.shape, name
        assert t.shape == (inp.klev + (name == "paph"), NCOL), name


@pytest.mark.parametrize("case", ["reference", "aerosol"])
@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_clamp_rule_rebuilds_the_device_pack(precision, case):
    """Row r of level lev read at level min(lev, h_r - 1), as the Rows
    policy reads it, is `pack_inputs`' pack bit for bit, edge rows
    included; PLSM, LDCUM != 0, KTYPE and PAPH's level nlev read in their
    own dtypes are what the kernel makes of the pack's `col`."""
    dtype = DTYPES[precision]
    inp, params, config, c, fields = _case(case, dtype)
    nlev = inp.klev
    p = cc.pack_inputs(fields, params, config)
    table = cc.row_table(fields, c)
    clamped = torch.stack([
        torch.stack([t[min(lev, t.shape[0] - 1)] for _, t in table])
        for lev in range(nlev + 1)])
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    assert p.rows == tuple(n for n, _ in table)
    assert torch.equal(clamped.view(ints), p.pack.view(ints))
    assert torch.equal(fields["plsm"], p.col[0])
    assert torch.equal(fields["ldcum"] != 0, p.col[1] > 0.5)
    assert torch.equal(fields["ktype"], p.col[2].to(torch.int32))
    assert torch.equal(fields["paph"][nlev], p.col[3])


@pytest.mark.parametrize("ncol", [8, 37])
@pytest.mark.parametrize("case", ["reference", "aerosol"])
@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_cpu_step_packs_and_reads_nothing_in_place(precision, case, ncol):
    """On the CPU the step reads a dict through its row table and the ZDQS
    row of `zdqs_plain`, as the Rows policy of the dict's build does, and
    packs nothing (`ops.pack` and `pack_bytes` 0, no launch): its raw
    buffers are the plain version's on `pack_inputs(fields)`, whose level
    loop runs the in-line CUADJTQ, bit for bit, the aerosol build's extra
    rows included, at a whole and a ragged column count."""
    dtype = DTYPES[precision]
    inp, params, config, c, fields = _case(case, dtype, ncol=ncol)
    step = cc.FusedStep(params, inp.ptsphy, dtype, config)
    tracing.reset()
    got = step(fields)
    assert [tracing.counter(n) for n in (
        "ops.pack", "pack_bytes", "ops.k1", "launches.k1.in_place",
        "launches.zdqs")] == [0] * 5
    assert tracing.counter("columns") == ncol
    want = cc.cloudsc_fused_plain(cc.pack_inputs(fields, params, config), c)
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a.view(ints), b.view(ints))


@pytest.mark.parametrize("fold_outputs", [True, False])
@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_cloud_tendencies_are_a_view_of_the_level_buffer(precision,
                                                         fold_outputs):
    """`assemble` returns TENDENCY_LOC_CLD as a view of the step's level
    buffer: `(NCLV, nlev, ncol)` over the same storage, the species'
    rows `len(OLEV_ROWS)` rows apart a level; its vapour plane is +0
    everywhere (K1 writes it), and it is bit for bit what `assemble`
    used to stack: the four cloud species' rows and a plane of zeros."""
    dtype = DTYPES[precision]
    inp, params, config, c, fields = _case("reference", dtype, ncol=37)
    step = cc.FusedStep(params, inp.ptsphy, dtype, config,
                        fold_outputs=fold_outputs)
    res = step(fields)
    o_lev = res[0]
    nlev, ncol = inp.klev, 37
    tcld = cc.assemble(res, fields, step.c, fold_outputs).tendency_loc_cld
    assert tcld.shape == (tscheme.NCLV, nlev, ncol)
    assert tcld.stride() == (ncol, len(cc.OLEV_ROWS) * ncol, 1)
    assert tcld.untyped_storage().data_ptr() == \
        o_lev.untyped_storage().data_ptr()
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    assert not tcld[tscheme.IV].view(ints).any()
    lev = {name: o_lev[:, j] for j, name in enumerate(cc.OLEV_ROWS)}
    old = torch.stack([lev[f"tcld{m}"] for m in range(4)]
                      + [torch.zeros_like(lev["tcld0"])])
    assert bool(torch.isfinite(tcld).all())
    assert torch.equal(tcld.view(ints), old.view(ints))


@pytest.mark.parametrize("mangled,key", [
    ("_ZN7cloudsc12fused_kernelIfNS_4PackEEEvPKT_S4_PKdPS2_S7_S7_iiiT0_",
     "fused_f32"),
    ("_ZN7cloudsc12fused_kernelIdNS_4RowsIdEEEEvPKT_S5_PKdPS3_S8_S8_iiiT0_",
     "fused_f64_rows"),
    ("_ZN7cloudsc12floor_kernelIdEEvPKT_S3_PKdPS1_S6_S6_iii", "floor_f64"),
    ("_ZN7cloudsc11zdqs_kernelIdEEvNS_10ZdqsConstsIT_EEPS2_iiNS_4RowsIS2_EE",
     "zdqs_f64"),
])
def test_kernel_key_names_the_policy(mangled, key):
    """The ptxas report keeps the two policies' builds of K1 apart, and
    zdqs_kernel (whose Rows table is a parameter, not a template argument)
    from both."""
    assert build.kernel_key(mangled) == key


def test_rows_entries_only_in_the_unfolded_build():
    """The Rows entries are declared, and looked up only where the build
    has them: the unfolded pack's rows are fields, a folded one's are
    not."""
    assert set(build.UNFOLDED_ONLY) == {
        f"cloudsc_fused_rows{o}_{t}" for o in ("", "_occupancy")
        for t in ("f32", "f64")} | {
        f"cloudsc_zdqs_rows_{t}" for t in ("f32", "f64")}
    assert all(n in build.ENTRY_POINTS for n in build.UNFOLDED_ONLY)
    v = cc.kernel_version(
        tscheme.derived_consts(
            Params.from_input(tdata.load_input(tdata.default_input_path(),
                                               8)), 1.0, torch.float32),
        cc.ROWS_FORM)
    assert (v.fold_inputs, v.fn, v.fc, v.fd) == (False, True, False, False)


@pytest.mark.parametrize("ncol", [8, 37])
@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_zdqs_plain_is_the_inline_chain(precision, ncol, monkeypatch):
    """`zdqs_plain` on a dict is, on every level the column sweep reaches
    (k >= NCLDTOP - 1), the ZDQS that `scheme.level_step`'s in-line chain
    computes in the plain version's level loop on `pack_inputs(fields)`,
    bit for bit; its last level is the chain with the PMF of the level
    below masked, and the levels above the cloud top, which K1 never reads,
    are 0. On the CPU `zdqs_row` is `zdqs_plain`. The last
    level's vertical velocity is set to 0 and its PMFU to a tenth of the
    forcing chain's clamp, so that the mask moves ZDQS there."""
    dtype = DTYPES[precision]
    inp, params, _, c, fields = _case("reference", dtype, ncol=ncol)
    nlev, ktop = inp.klev, c.NCLDTOP - 1
    last = nlev - 1
    zdp = fields["paph"][last + 1] - fields["paph"][last]
    fields = dict(fields, pvervel=fields["pvervel"].clone(),
                  pmfu=fields["pmfu"].clone(), pmfd=fields["pmfd"].clone())
    fields["pvervel"][last] = 0.0
    fields["pmfu"][last] = 0.1 * zdp * c.zqtmst / (0.5 * c.RG)
    fields["pmfd"][last] = 0.0
    zdqs = cc.zdqs_plain(fields, c)
    assert zdqs.shape == (nlev, ncol) and zdqs.dtype == dtype
    assert bool(torch.isfinite(zdqs).all())
    assert not bool(zdqs[:ktop].any())
    assert torch.equal(cc.zdqs_row(fields, c), zdqs)
    seen = []
    inline = tscheme.cuadj_zdqs

    def record(*args):
        seen.append(inline(*args))
        return seen[-1]

    monkeypatch.setattr(tscheme, "cuadj_zdqs", record)
    cc.cloudsc_fused_plain(cc.pack_inputs(fields, params), c)
    assert len(seen) == nlev - ktop
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    for k, z in zip(range(ktop, nlev), seen):
        assert torch.equal(z.view(ints), zdqs[k].view(ints)), k
    # the last level: PMF of the level below (the clamped read) masked
    pmf = fields["pmfu"][last] + fields["pmfd"][last]
    ztp1 = fields["pt"][last] + c.ptsphy * fields["tendency_tmp_t"][last]
    pap = fields["pap"][last]
    zqsmix = tscheme.sat_mix(ztp1, tscheme.foealfa(ztp1, c.thf), pap, c)[3]
    args = (ztp1, pap, zdp, pmf, pmf)
    rest = (fields["pvervel"][last],
            fields["phrsw"][last] + fields["phrlw"][last], zqsmix, c)
    unmasked = inline(*args, torch.tensor(True), *rest)
    assert torch.equal(inline(*args, torch.tensor(False), *rest),
                       zdqs[last])
    assert not torch.equal(unmasked, zdqs[last])
