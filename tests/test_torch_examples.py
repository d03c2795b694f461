"""The port's worked examples, its timestep loop and its energy monitor, on
the CPU: the loop against the JAX package's `examples/timestep_loop` under
`jax.lax.scan` on the same inputs (final state relative 1e-10 of each
field's largest value, 6.8e-13 measured on an x86 CPU; tests/
test_timestep_loop.py's physical checks), each example's `main` at a reduced
size, and tests/test_pmon.py's cases on the port's module with NVML replaced
by a stub library object.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc_tpu.physics import make_inputs as jmake_inputs
from cloudsc_tpu_torch import data as tdata
from cloudsc_tpu_torch.examples import adjoint_sensitivity, \
    param_calibration, timestep_loop
from cloudsc_tpu_torch.params import Params as TParams
from cloudsc_tpu_torch.physics.cloudsc import cloudsc, make_inputs
from cloudsc_tpu_torch.runtime import pmon
from cloudsc_tpu_torch.runtime.driver import CloudscDriver

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import timestep_loop as jax_loop  # noqa: E402  (the JAX package's example)

torch.set_num_threads(1)

NSTEPS = 3


@pytest.fixture(scope="module")
def port_loop():
    inp = tdata.load_input(tdata.default_input_path(), 100)
    params = TParams.from_input(inp)
    fields = make_inputs(inp, torch.float64)
    step = timestep_loop.make_step(fields, params, inp.ptsphy)
    state0 = {k: fields[k] for k in timestep_loop.STATE_KEYS}
    final, diags = timestep_loop.integrate(step, state0, NSTEPS)
    return inp, params, fields, state0, final, diags


def test_loop_matches_jax_scan(port_loop, input_100, params):
    """Three chained steps against the JAX example's scan body."""
    _, _, _, _, final, diags = port_loop
    assert timestep_loop.STATE_KEYS == jax_loop.STATE_KEYS
    fields = jmake_inputs(input_100, dtype=jnp.float64)
    step = jax_loop.make_step(fields, params, input_100.ptsphy)
    state0 = {k: fields[k] for k in jax_loop.STATE_KEYS}
    jfinal, jdiags = jax.jit(
        lambda s: jax.lax.scan(step, s, None, length=NSTEPS))(state0)
    for k in jax_loop.STATE_KEYS:
        want = np.asarray(jfinal[k])
        got = final[k].numpy()
        assert got.shape == want.shape, k
        scale = max(np.abs(want).max(), 1e-300)
        assert np.abs(got - want).max() <= 1e-10 * scale, k
    for k in ("sprecip", "wpath"):
        np.testing.assert_allclose(diags[k].numpy(), np.asarray(jdiags[k]),
                                   rtol=1e-10, atol=0.0)


def test_chained_steps_finite_and_physical(port_loop):
    inp, params, fields, state0, final, diags = port_loop
    for k in ("pt", "pq", "pa", "pclv"):
        assert bool(torch.isfinite(final[k]).all()), k
    assert float(final["pa"].min()) >= 0.0 and float(final["pa"].max()) <= 1.0
    # temperatures stay in an atmospheric range after 3 h of physics
    assert 150.0 < float(final["pt"].min())
    assert float(final["pt"].max()) < 340.0
    sprecip = diags["sprecip"].numpy()
    assert (sprecip >= 0.0).all()
    # water budget: path change + surface precip = in-column source
    # (detrainment + supersat) >= 0 — the loop must not destroy water
    q0 = float(timestep_loop.water_path(fields, params, state0))
    src = (float(diags["wpath"][-1]) - q0) + inp.ptsphy * sprecip.sum()
    assert src > -1e-9


def test_first_loop_step_is_plain_single_step(port_loop):
    inp, params, fields, _, _, diags = port_loop
    with torch.no_grad():
        out = cloudsc(fields, params, inp.ptsphy)
    sp1 = (out.pfplsl[-1] + out.pfplsn[-1]).mean()
    assert float(diags["sprecip"][0]) == float(sp1)


def test_column_weight_matches_jax(port_loop, input_100, params):
    _, tparams, fields, _, _, _ = port_loop
    want = np.asarray(jax_loop.column_weight(
        jmake_inputs(input_100, dtype=jnp.float64), params))
    np.testing.assert_array_equal(
        timestep_loop.column_weight(fields, tparams).numpy(), want)


# ---- each example's main, on the CPU at a reduced size -----------------------

def test_adjoint_sensitivity_main(capsys):
    assert adjoint_sensitivity.main(["--device", "cpu", "--ngptot", "48"]) == 0
    out = capsys.readouterr().out
    assert "adjoint sensitivity d(surface precip)/d(T level)" in out
    # columns 0, 17 and 42 of the example's four fit in 48
    assert out.count("  column ") == 3 and "column  42:" in out
    assert "nonzero sensitivities:" in out and "of 6576" in out


def test_param_calibration_main(capsys):
    assert param_calibration.main(["--device", "cpu", "--ngptot", "40"]) == 0
    out = capsys.readouterr().out
    for name in param_calibration.TUNABLE:
        assert f"  {name:<10} " in out, name
    assert "recovering RCLDIFF" in out and "  it 11: theta" in out
    rel = float(out.split("(rel err ")[1].split(")")[0])
    assert rel < 0.05
    assert "perturbed-parameter ensemble (9 members, one run):" in out
    assert out.count("-> tendency misfit") == 9


def test_timestep_loop_main(capsys):
    assert timestep_loop.main(["--device", "cpu", "--ngptot", "40",
                               "--nsteps", "2"]) == 0
    out = capsys.readouterr().out
    assert "2 steps x dt=3600 s, 40 columns, fp64 eager engine on cpu" in out
    assert "water budget over 2 steps" in out
    assert "implied in-column source" in out


def test_examples_default_to_the_card():
    """No fallback: asked for nothing, an example wants the card and raises
    without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path needs none")
    for mod in (adjoint_sensitivity, param_calibration, timestep_loop):
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main(["--ngptot", "8"])


# ---- the energy monitor (tests/test_pmon.py's cases) -------------------------

class StubNvml:
    """What `pmon.NvmlSource` calls of libnvidia-ml, with a counter that
    advances `step_mj` millijoules a reading."""

    def __init__(self, energy_mj=5_000_000, step_mj=1500, power_mw=412_000,
                 rc=0):
        self.energy_mj, self.step_mj = energy_mj, step_mj
        self.power_mw, self.rc = power_mw, rc
        self.by_index = self.by_pci = None

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        self.by_index = index
        return self.rc

    def nvmlDeviceGetHandleByPciBusId_v2(self, bus_id, handle):
        self.by_pci = bus_id
        return self.rc

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, out):
        out._obj.value = self.energy_mj  # `out` is a ctypes.byref
        self.energy_mj += self.step_mj
        return self.rc

    def nvmlDeviceGetPowerUsage(self, handle, out):
        out._obj.value = self.power_mw
        return self.rc


def test_disabled_without_env(monkeypatch):
    monkeypatch.delenv("EC_PMON", raising=False)
    assert pmon.energy_power() is None
    assert pmon.energy_power(pmon.NvmlSource(lib=StubNvml())) is None
    s = pmon.EnergySampler()
    s.start()
    assert s.stop_and_report() is None


def test_enabled_reads_or_none(monkeypatch):
    monkeypatch.setenv("EC_PMON", "1")
    # on hosts without Cray counters/RAPL this is None; where counters exist
    # it must return (energy_J, power_W) floats
    r = pmon.energy_power()
    if r is not None:
        e, p = r
        assert e >= 0.0 and p >= 0.0


def test_nvml_source_reads_the_card(monkeypatch):
    """Millijoules and milliwatts become joules and watts; the card is
    found by its PCI bus id where given, by index otherwise; the report is
    the JAX package's line."""
    monkeypatch.setenv("EC_PMON", "1")
    stub = StubNvml()
    src = pmon.NvmlSource(index=0, lib=stub, pci_bus_id="00000000:3b:00.0")
    assert stub.by_pci == b"00000000:3b:00.0" and stub.by_index is None
    assert pmon.energy_power(src) == (5000.0, 412.0)
    s = pmon.EnergySampler(source=src)
    s.start()
    assert s.stop_and_report() == " EC_PMON: energy delta 1.5 J, power 412 W"
    stub2 = StubNvml()
    pmon.NvmlSource(index=3, lib=stub2)
    assert stub2.by_index == 3 and stub2.by_pci is None


def test_nvml_failure_raises(monkeypatch):
    """With EC_PMON set, a card and no working NVML, nothing is reported in
    the card's place: it raises."""
    monkeypatch.setenv("EC_PMON", "1")
    with pytest.raises(RuntimeError, match="NVML error 999"):
        pmon.NvmlSource(lib=StubNvml(rc=999))
    src = pmon.NvmlSource(lib=StubNvml())
    src.lib.rc = 3
    with pytest.raises(RuntimeError, match="NVML error 3"):
        src.energy_power()
    monkeypatch.setattr(pmon, "_NVML_NAME", "libnvidia-ml-not-there.so.1")
    with pytest.raises(RuntimeError, match="needs NVML"):
        pmon.load_nvml()


def test_driver_samples_energy(monkeypatch, tmp_path):
    """driver.run samples EC_PMON around the timed loop and surfaces the
    report in Timings; on the host the counters are the Cray paths, faked
    here."""
    e = tmp_path / "energy"
    p = tmp_path / "power"
    e.write_text("1000 J")
    p.write_text("50 W")
    monkeypatch.setenv("EC_PMON", "1")
    monkeypatch.setattr(pmon, "_CRAY_ENERGY", e)
    monkeypatch.setattr(pmon, "_CRAY_POWER", p)
    inp = tdata.load_input(tdata.default_input_path(), 16)
    driver = CloudscDriver(TParams.from_input(inp), inp.ptsphy,
                           dtype=torch.float64, device="cpu")
    _, timings, _ = driver.run(inp)
    assert timings.energy_line == " EC_PMON: energy delta 0.0 J, power 50 W"
    monkeypatch.delenv("EC_PMON")
    _, timings, _ = driver.run(inp)
    assert timings.energy_line is None


def test_cli_prints_energy_line(monkeypatch, tmp_path, capsys):
    from cloudsc_tpu_torch import cli

    (tmp_path / "energy").write_text("1000 J")
    (tmp_path / "power").write_text("50 W")
    monkeypatch.setenv("EC_PMON", "1")
    monkeypatch.setattr(pmon, "_CRAY_ENERGY", tmp_path / "energy")
    monkeypatch.setattr(pmon, "_CRAY_POWER", tmp_path / "power")
    assert cli.main(["1", "16", "16", "--device", "cpu", "--precision",
                     "fp64", "--no-validate"]) == 0
    lines = capsys.readouterr().out.splitlines()
    i = next(i for i, ln in enumerate(lines) if "device compute:" in ln)
    assert lines[i + 1] == " EC_PMON: energy delta 0.0 J, power 50 W"
