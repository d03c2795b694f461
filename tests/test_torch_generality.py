"""The JAX tests of generality and robustness, mirrored for the port, on
the CPU:

  * tests/test_level_generality.py: the atmosphere cut at 61, 68 and 91
    levels (its `_truncated`, which keeps the top); the eager engine and
    K1's plain version on the folded pack each against the JAX scan
    engine, finite, with the JAX test's bound: max |a - b| / max |a| <
    2e-5 a field. In fp64, where the two frameworks agree far inside it:
    in fp32 one ulp of `exp` between torch and XLA on the CPU flips
    threshold branches (ROADMAP Queue 3). `cuda_cloudsc.ring_schedule`,
    K1's ring, replayed at those level counts (no fault);
  * tests/test_robustness.py: its seeded perturbed states (its
    `_perturbed_fields`, 100 columns) through the eager engine (seeds 0-2:
    finite, cover and rain fraction in [0, 1], |dT/dt| < 0.1 K/s) and K1's
    plain version (seed 3), each against the JAX scan engine under the
    same 2e-5 bound, in fp64; `test_validation_table_survives_nonfinite`
    against the port's `validate`;
  * tests/test_invariance.py::test_padding_invariance: the scan driver's
    NPROMA padding (100 columns padded with zeros to 128) leaves the real
    columns bit for bit as 128 real columns give them; against the
    unpadded engine, bit for bit but for the last column, which the CPU's
    scalar tail code rounds apart (stated in the test).

The card's twins (K1 against its plain version at these level counts and
on a perturbed state, bit for bit) are in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc_tpu.physics import cloudsc as jcloudsc
from cloudsc_tpu.physics import make_inputs as jmake_inputs
from cloudsc_tpu_torch import data as tdata
from cloudsc_tpu_torch import validate as tvalidate
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.params import Params as TParams
from cloudsc_tpu_torch.physics import cloudsc as tcloudsc
from cloudsc_tpu_torch.physics import scheme as tscheme
from cloudsc_tpu_torch.runtime.driver import CloudscDriver

from test_level_generality import _truncated
from test_robustness import FINITE_OUTPUTS, _perturbed_fields
from test_torch_kernel import _replay_ring

torch.set_num_threads(1)

# test_level_generality's and test_robustness's cross-engine bound
MAXREL = 2e-5
LEVEL_FIELDS = ("tendency_loc_t", "tendency_loc_q", "pcovptot", "pfplsl",
                "pfplsn", "plude")
PERTURBED_FIELDS = ("tendency_loc_t", "tendency_loc_q", "pcovptot", "pfplsl",
                    "pfplsn")


@pytest.fixture(scope="module")
def tinp():
    inp = tdata.load_input(tdata.default_input_path(), 100)
    return inp, TParams.from_input(inp)


@pytest.fixture(scope="module")
def jax_scan(params, input_100):
    return jax.jit(lambda f: jcloudsc(f, params, input_100.ptsphy))


def _engine(inp, params):
    return tcloudsc.cloudsc(tcloudsc.make_inputs(inp, torch.float64), params,
                            inp.ptsphy)


def _plain_kernel(inp, params):
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float64)
    p = cc.pack_inputs_folded(inp, params, dtype=torch.float64)
    return cc.assemble(cc.cloudsc_fused_plain(p, c), p, c)


def _agree(want, got, names, tag):
    for name in names:
        a = np.asarray(getattr(want, name), dtype=np.float64)
        b = getattr(got, name).numpy()
        assert a.shape == b.shape, f"{tag} {name}"
        assert np.isfinite(b).all(), f"{tag} {name}: non-finite"
        maxrel = np.abs(a - b).max() / (np.abs(a).max() + 1e-30)
        assert maxrel < MAXREL, f"{tag} {name}: {maxrel:.3e}"


@pytest.mark.parametrize("engine", ["scan", "kernel_plain"])
@pytest.mark.parametrize("nlev", [61, 68, 91])
def test_engines_agree_at_any_level_count(input_100, tinp, jax_scan, nlev,
                                          engine):
    want = jax_scan(jmake_inputs(_truncated(input_100, nlev),
                                 dtype=jnp.float64))
    inp, params = tinp
    run = _engine if engine == "scan" else _plain_kernel
    got = run(_truncated(inp, nlev), params)
    assert got.pfplsl.shape == (nlev + 1, 100)
    assert got.plude.shape == (nlev, 100)
    _agree(want, got, LEVEL_FIELDS, f"{engine} L{nlev}")


@pytest.mark.parametrize("nlev", [61, 68, 91])
def test_ring_schedule_at_any_level_count(nlev):
    stages = cc.RING.stages
    ops = cc.ring_schedule(nlev, stages)
    assert _replay_ring(ops, nlev, stages) == []
    assert sum(op[0] == "copy" for op in ops) == nlev + 1


def _perturbed(input_100, tinp, seed):
    """(JAX field dict, the port's InputData holding the same values): the
    JAX test's perturbation, at 100 columns, where make_inputs only casts."""
    jf = _perturbed_fields(input_100, jnp.float64, seed)
    inp, _ = tinp
    fields = dict(inp.fields)
    for key, name in tcloudsc._PLAIN:
        fields[name] = np.array(jf[key], np.float64)
    return jf, dataclasses.replace(inp, fields=fields)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_finite_and_physical_on_perturbed_states(input_100, tinp,
                                                        jax_scan, seed):
    jf, pinp = _perturbed(input_100, tinp, seed)
    out = _engine(pinp, tinp[1])
    for name in FINITE_OUTPUTS:
        assert bool(torch.isfinite(getattr(out, name)).all()), \
            f"{name}: NaN/inf under seed {seed}"
    cov, rf = out.pcovptot, out.prainfrac_toprfz
    assert bool(((cov >= 0) & (cov <= 1)).all())
    assert bool(((rf >= 0) & (rf <= 1)).all())
    assert float(out.tendency_loc_t.abs().max()) < 0.1
    _agree(jax_scan(jf), out, PERTURBED_FIELDS, f"engine seed {seed}")


def test_plain_kernel_agrees_on_perturbed_state(input_100, tinp, jax_scan):
    jf, pinp = _perturbed(input_100, tinp, 3)
    out = _plain_kernel(pinp, tinp[1])
    for name in FINITE_OUTPUTS:
        assert bool(torch.isfinite(getattr(out, name)).all()), name
    _agree(jax_scan(jf), out, PERTURBED_FIELDS, "kernel plain seed 3")


def test_validation_table_survives_nonfinite():
    """A NaN or an infinity still prints its row, flagged (validate.py's
    FieldErrors.flagged); the Fortran E20.13 edit prints NaN / Infinity
    in a 20-character field."""
    ref = np.linspace(0.1, 1.0, 64).reshape(8, 8)
    for bad in (np.nan, np.inf, -np.inf):
        field = ref.copy()
        field[3, 4] = bad
        errs = tvalidate.field_errors("PCOVPTOT", field, ref)
        assert errs.flagged, f"non-finite stats not flagged for {bad}"
        line = tvalidate.error_line(errs)
        assert "!!!!" in line
        assert ("NaN" in line) or ("Infinity" in line)
        assert len(line.split()) >= 7
    assert tvalidate._e20_13(float("nan")).strip() == "NaN"
    assert tvalidate._e20_13(float("inf")).strip() == "Infinity"
    assert tvalidate._e20_13(float("-inf")).strip() == "-Infinity"
    assert all(len(tvalidate._e20_13(v)) == 20
               for v in (float("nan"), float("inf"), float("-inf")))


def test_padding_invariance(tinp):
    """The scan driver pads 100 columns with zeros to 128 (NPROMA 64):
    the real columns equal, bit for bit, the engine's on 128 real columns
    (the snapshot tiled), so the padding's content reaches no real column.
    Against the unpadded 100-column engine, columns 0-98 are equal bit for
    bit; column 99, the last of a row whose width is not a multiple of the
    host's vector width, goes through the CPU's scalar tail code in the
    unpadded run and may differ in the last bits: within 1e-14 of the
    field's largest value (3.6e-15 measured; the card has no such tail,
    tests/test_torch_cuda.py holds the padding bit for bit there)."""
    inp, params = tinp
    driver = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                           device="cpu", backend="scan", nproma=64)
    assert driver.prepare(inp)["pt"].shape == (137, 128)
    padded, _, _ = driver.run(inp)
    tiled = _engine(tdata.load_input(tdata.default_input_path(), 128),
                    params)
    plain = _engine(inp, params)
    for name in plain._fields:
        got = getattr(padded, name)
        assert got.shape[-1] == 100, name
        np.testing.assert_array_equal(got, getattr(tiled, name)[..., :100]
                                      .numpy(), err_msg=name)
        want = getattr(plain, name).numpy()
        np.testing.assert_array_equal(got[..., :99], want[..., :99],
                                      err_msg=name)
        tail = np.abs(got[..., 99] - want[..., 99]).max()
        assert tail <= 1e-14 * np.abs(want).max(), f"{name}: {tail:.3e}"
