"""The port's sweep (`python -m cloudsc_tpu_torch.bench.sweep`) on the CPU:
the counterpart of the JAX package's `bench/sweep.py`.

  * its JUBE scrape targets (RE_TOTAL, RE_DEVICE, RE_FLAGGED) are the JAX
    sweep's, loaded by file path, and both match the port's CLI output; the
    flagged validation rows scrape to their MaxRelErr;
  * a `--cpu` grid of two points gives records with the JAX keys, the
    precision, a positive columns/s and no fp64 field over its bar;
  * `--weak-scaling 1 2 --cpu` gives rehearsal records whose base is N=1,
    with the bench entry's default columns a share scaled by N;
  * a failed smallest run gives no efficiencies;
  * an N above the card count is refused without `--cpu`;
  * the fp64 judgement: FP64_TOL, and the JAX engine's reading by size; a
    point over either fails the sweep.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

from cloudsc_tpu_torch import cli
from cloudsc_tpu_torch.bench import bench, sweep

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _jax_sweep():
    path = REPO / "bench" / "sweep.py"
    spec = importlib.util.spec_from_file_location("jax_sweep", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cli_fp32_256():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["1", "256", "128", "--device", "cpu",
                         "--precision", "fp32"]) == 0
    return buf.getvalue()


@pytest.mark.parametrize("name", ["RE_TOTAL", "RE_DEVICE", "RE_FLAGGED"])
def test_patterns_are_the_jax_sweeps(name, cli_fp32_256):
    ours, theirs = getattr(sweep, name), getattr(_jax_sweep(), name)
    assert ours.pattern == theirs.pattern and ours.flags == theirs.flags
    lines = cli_fp32_256.splitlines()
    hits = [ln for ln in lines
            if (ours.match(ln) if name == "RE_TOTAL" else ours.search(ln))]
    assert hits == [ln for ln in lines
                    if (theirs.match(ln) if name == "RE_TOTAL"
                        else theirs.search(ln))]
    assert len(hits) == {"RE_TOTAL": 1, "RE_DEVICE": 1}.get(name, len(hits))
    assert hits


def test_scrape_reads_the_cli(cli_fp32_256):
    rec = sweep.scrape(cli_fp32_256)
    assert rec["cols_per_s"] > 0 and rec["time_ms"] > 0
    assert rec["compute_ms"] > 0 and rec["compile_s"] > 0
    assert "peak_mib" not in rec  # printed on the card only
    flagged_lines = [ln for ln in cli_fp32_256.splitlines()
                     if ln.rstrip().endswith("!!!!")]
    assert rec["validation_flags"] == len(flagged_lines) > 0
    for ln in flagged_lines:
        name, pct = ln.split()[0], float(ln.split()[-2])
        assert rec["flagged"][name] == pct / 100.0


def test_cpu_grid(tmp_path):
    out = tmp_path / "grid.json"
    rc = sweep.main(["--cpu", "--ngptot", "128", "--kernel", "auto", "scan",
                     "--precision", "fp64", "--iterations", "1",
                     "--validate", "--out", str(out)])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert [(r["kernel"], r["precision"]) for r in recs] == [
        ("auto", "fp64"), ("scan", "fp64")]
    jax_keys = {"ngptot", "nproma", "kernel", "iterations", "rc", "time_ms",
                "mflops", "cols_per_s", "compute_ms", "h2d_ms", "d2h_ms",
                "compile_s", "validation_flags"}
    for r in recs:
        assert jax_keys <= set(r), r
        assert r["cols_per_s"] > 0 and r["wall_s"] > 0
        assert r["over_fp64_tol"] == {}
        assert r["over_jax_reading"] is None  # no JAX reading at 128


def test_cpu_weak_scaling(tmp_path):
    out = tmp_path / "weak.json"
    rc = sweep.main(["--weak-scaling", "1", "2", "--cpu", "--iterations",
                     "1", "--out", str(out)])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert [r["ndev"] for r in recs] == [1, 2]
    for r in recs:
        assert r["rc"] == 0 and r["rehearsal"] is True
        assert "rehearsal_reason" in r and r["value"] > 0
        assert f"{bench.CPU_NGPTOT * r['ndev']} cols" in r["metric"]
    assert recs[0]["efficiency"] == 1.0
    assert recs[0]["serialized_efficiency"] == 1.0
    assert recs[1]["efficiency"] == round(recs[1]["value"]
                                          / recs[0]["value"], 4)
    assert recs[1]["serialized_efficiency"] == round(
        2 * recs[1]["value"] / recs[0]["value"], 4)


@pytest.mark.parametrize("cpu", [False, True])
def test_failed_smallest_run_gives_no_efficiencies(cpu):
    recs = [dict(ndev=2, rc=0, value=100.0), dict(ndev=1, rc=1),
            dict(ndev=4, rc=0, value=90.0)]
    assert sweep.efficiencies(recs, cpu) is None
    assert all(r["efficiency"] is None for r in recs)
    assert all(r.get("serialized_efficiency") is None for r in recs)
    ok = [dict(ndev=4, rc=0, value=90.0), dict(ndev=2, rc=0, value=100.0)]
    assert sweep.efficiencies(ok, cpu) == 100.0
    assert ok[0]["efficiency"] == 0.9


def test_more_cards_than_present_are_refused(capsys):
    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit) as e:
        sweep.main(["--weak-scaling", "1", str(n)])
    assert e.value.code != 0
    assert "device_count()" in capsys.readouterr().err


def test_fp64_verdict():
    jax = sweep.JAX_FP64_RELERR[163840]
    ok = {"PFSQLF": jax["PFSQLF"], "TENDENCY_LOC%T": 1e-15}
    assert sweep.fp64_verdict(163840, ok) == dict(over_fp64_tol={},
                                                  over_jax_reading={})
    worse = {"PFSQLF": 2 * jax["PFSQLF"], "PFCQLNG": 3e-15}
    got = sweep.fp64_verdict(163840, worse)
    assert set(got["over_jax_reading"]) == {"PFSQLF", "PFCQLNG"}
    assert got["over_fp64_tol"] == {}
    assert sweep.fp64_verdict(163840, {"PLUDE": 6e-14})["over_fp64_tol"] \
        == {"PLUDE": 6e-14}
    assert sweep.fp64_verdict(1000, worse)["over_jax_reading"] is None


@pytest.mark.parametrize("verdict", [
    dict(over_fp64_tol={"PLUDE": 6e-14}, over_jax_reading={}),
    dict(over_fp64_tol={}, over_jax_reading={"PFSQLF": 4e-14}),
    dict(over_fp64_tol={}, over_jax_reading=None)])
def test_fp64_verdict_decides_the_exit_code(verdict, monkeypatch, tmp_path):
    """A grid point that ran to exit 0 but has a field over FP64_TOL or the
    JAX engine's reading fails the sweep; one judged only by FP64_TOL (no
    JAX reading at its size) and within it passes."""
    def run_case(ngptot, nproma, kernel, precision, iterations, validate,
                 cpu):
        return dict(ngptot=ngptot, nproma=nproma, kernel=kernel,
                    precision=precision, iterations=iterations, rc=0,
                    cols_per_s=1, **verdict)

    monkeypatch.setattr(sweep, "run_case", run_case)
    rc = sweep.main(["--cpu", "--ngptot", "128", "--kernel", "scan",
                     "--precision", "fp64", "--validate", "--out",
                     str(tmp_path / "grid.json")])
    assert rc == (0 if verdict["over_jax_reading"] is None else 1)
