"""The `layout` a configuration may state: the dwarf's NPROMA blocks held,
handed to the program and compared, and the plain columns left as they
were.

  * the blocked field dict un-blocks to the columns layout's bit for bit,
    fp32 and fp64, on two shares at non-zero offsets, every key;
  * a resident loop set up under a tiny blocked configuration reads 0 on
    the reference's own outputs handed back in blocks, and fails when a
    block's lanes are rolled, two blocks swapped or two species swapped;
  * each refusal raises before any unit: an unknown layout, a share that
    is not a whole number of blocks, the dwarf loop under blocks, and an
    output that lacks its blocked shape.
"""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from cellbench import calibrate, inputs, loops, reference

TINY = str(Path(__file__).resolve().parent / "tiny.json")
SEED = 2**31 + 2021
NPROMA = 16
# (start, columns) of two shares, neither at column 0: three blocks each
SHARES = ((48, 48), (96, 48))
PER_COLUMN = ("plsm", "ldcum", "ktype")
BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


@pytest.fixture(scope="module")
def snap():
    fields, scalars = inputs.load_snapshot()
    amplitude = {"PT": 0.001, "PQ": 0.05, "PCLV": 0.05,
                 "TENDENCY_TMP_CLD": 0.05}
    return inputs.seeded_snapshot(fields, scalars, SEED, amplitude), amplitude


def _bits(t):
    """`t`'s bits, so that equal means bit for bit."""
    return t.contiguous().view(BITS.get(t.dtype, t.dtype))


def _dict(snap, precision, share, start, ncol, **layout):
    fields, amplitude = snap
    return inputs.field_dict(
        fields, ncol, precision, "cpu", start=start, amplitude=amplitude,
        generator=inputs.share_generator(SEED, share, "cpu"), **layout)


# -- (a) the blocked dict holds the columns dict's values ------------------

@pytest.mark.parametrize("precision", ["fp32", "fp64"])
def test_blocked_dict_unblocks_to_the_columns_dict(snap, precision):
    for share, (start, ncol) in enumerate(SHARES):
        cols = _dict(snap, precision, share, start, ncol)
        same = _dict(snap, precision, share, start, ncol, layout="columns",
                     nproma=NPROMA)
        blocked = _dict(snap, precision, share, start, ncol,
                        layout="nproma_blocks", nproma=NPROMA)
        assert list(blocked) == list(cols) == list(same)
        nblk = ncol // NPROMA
        for k, c in cols.items():
            b = blocked[k]
            assert torch.equal(same[k], c) and same[k].stride() == \
                c.stride(), k
            # the dwarf's (NPROMA, ..., NGPBLKS) as a C-contiguous tensor
            assert b.shape == (nblk, *c.shape[:-1], NPROMA), k
            assert b.is_contiguous() and b.dtype == c.dtype, k
            # block 1, lane 5 is column 1 * NPROMA + 5
            assert torch.equal(b[1, ..., 5], c[..., NPROMA + 5]), k
            back = inputs.from_blocks(b)
            assert back.shape == c.shape, k
            assert torch.equal(_bits(back), _bits(c)), k
        assert blocked["paph"].shape == (nblk, 138, NPROMA)
        for k in ("pclv", "tendency_tmp_cld"):
            assert blocked[k].shape == (nblk, 5, 137, NPROMA)
        for k in PER_COLUMN:
            assert blocked[k].shape == (nblk, NPROMA)


def test_shares_draw_their_own_values(snap):
    a = _dict(snap, "fp64", 0, *SHARES[0], layout="nproma_blocks",
              nproma=NPROMA)
    b = _dict(snap, "fp64", 1, *SHARES[1], layout="nproma_blocks",
              nproma=NPROMA)
    assert not torch.equal(a["pt"], b["pt"])


# -- (b) the blocked comparison --------------------------------------------

def _blocked_cell(tiny, workload="dp-jube.resident", **config):
    cell = calibrate.cell_for(workload, SEED, rehearse=tiny)
    cell.config.update({"layout": "nproma_blocks", "nproma": NPROMA,
                        **config})
    return cell


@pytest.fixture(scope="module")
def blocked_loop():
    """A resident loop under dp-jube's configuration at 48 columns in
    blocks of 16, and the reference's own outputs of its share in blocks:
    what a sound program hands back."""
    loop = loops.Resident(_blocked_cell(TINY), loops.Spans())
    outs = []
    for _, fields, _ in loop.reference_inputs():
        ref = reference.step(fields, loop.ref_params, loop.ptsphy,
                             loop.ref_config)
        outs.append(reference.Outputs(*(inputs.to_blocks(r, NPROMA)
                                        for r in ref)))
    return loop, outs


def _roll_block(o):
    o = o.clone()
    o[1] = o[1].roll(1, dims=-1)
    return o


def _swap_blocks(o):
    return o[[2, 1, 0]].clone()


def _faulty(outs, fault):
    """The outputs with `fault` planted in every field of every share,
    or in the cloud tendencies' species for `species`."""
    out = []
    for o in outs:
        if fault == "species":
            cld = o.tendency_loc_cld[:, [1, 0, 2, 3, 4]].clone()
            out.append(o._replace(tendency_loc_cld=cld))
        else:
            f = {"roll": _roll_block, "swap": _swap_blocks}[fault]
            out.append(reference.Outputs(*(f(t) for t in o)))
    return out


def test_blocked_comparison_reads_zero_on_the_reference(blocked_loop):
    loop, outs = blocked_loop
    assert loop.payloads[0]["pt"].shape == (48 // NPROMA, 137, NPROMA)
    cmp = loop.compare(outs)
    assert cmp.columns == 48
    assert {k: v for k, (v, _) in cmp.numbers().items()} == {
        "rel_l1": 0.0, "rel_max": 0.0}
    assert cmp.correct()


@pytest.mark.parametrize("fault", ["roll", "swap", "species"])
def test_blocked_comparison_fails_each_fault(blocked_loop, fault):
    loop, outs = blocked_loop
    cmp = loop.compare(_faulty(outs, fault))
    assert not cmp.correct(), fault
    assert any(v > loop.cell.config["limits"][k]
               for k, (v, _) in cmp.numbers().items())


def test_blocked_control_is_not_correct(blocked_loop):
    loop, outs = blocked_loop
    assert not loop.compare(outs, control=True).correct()


def test_an_output_without_its_blocked_shape_raises(blocked_loop):
    loop, outs = blocked_loop
    flat = outs[0]._replace(pfsqlf=inputs.from_blocks(outs[0].pfsqlf))
    with pytest.raises(ValueError, match="pfsqlf"):
        loop.compare([flat])


# -- (c) refusals before any unit ------------------------------------------

@pytest.fixture
def no_unit(monkeypatch):
    """Any unit run fails the test."""
    def unit(self):
        raise AssertionError("a unit ran")

    for cls in (loops.Resident, loops.Dwarf):
        monkeypatch.setattr(cls, "unit", unit)


def _measure(cell):
    return loops.measure(cell, lambda: 0.0)


def test_field_dict_refuses(snap):
    fields, _ = snap
    with pytest.raises(ValueError, match="whole number of NPROMA blocks"):
        inputs.field_dict(fields, 40, "fp64", "cpu", layout="nproma_blocks",
                          nproma=NPROMA)
    with pytest.raises(ValueError, match="whole number of NPROMA blocks"):
        inputs.field_dict(fields, 48, "fp64", "cpu", layout="nproma_blocks")
    with pytest.raises(ValueError, match="unknown layout 'blocks'"):
        inputs.field_dict(fields, 48, "fp64", "cpu", layout="blocks",
                          nproma=NPROMA)


@pytest.mark.parametrize("workload,config,match", [
    ("dp-jube.resident", {"columns_per_chip": 40},
     "share of 40 columns is not a whole number of NPROMA blocks of 16"),
    ("dp-node4-262k.resident", {"columns_per_chip": 24},
     "share of 24 columns is not a whole number of NPROMA blocks of 16"),
    ("dp-jube.resident", {"layout": "fortran"}, "unknown layout 'fortran'"),
])
def test_resident_refuses_before_any_unit(no_unit, tiny, workload, config,
                                          match):
    with pytest.raises(ValueError, match=match):
        _measure(_blocked_cell(tiny, workload, **config))


def test_dwarf_refuses_blocks_before_any_unit(no_unit, tiny):
    cell = _blocked_cell(tiny)
    cell.traffic = calibrate.load_json(calibrate.HERE / "traffic"
                                       / "dwarf.json")
    with pytest.raises(ValueError, match="dwarf loop .* 'nproma_blocks'"):
        _measure(cell)
