"""The CPU rehearsal: every cell's traffic driven end to end on the plain
PyTorch versions at the tiny size of `tiny.json`; the result line's keys;
the refusal without a card and with JAX loaded; the harness finding new
files by name; the faults and the lower-precision control coming out as
not correct."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cellbench import calibrate, run

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# cells the harness runs that BENCHMARK.json does not hold yet (PERF.md §7):
# the dwarf mix and the 4-card mesh, added here by entries alone
PARKED = {
    "configs": [{"name": "dp-node4", "file": "cellbench/configs/dp-node4.json"}],
    "workloads": [
        {"name": "dp-jube.dwarf", "config": "dp-jube", "traffic": "dwarf",
         "chips": 1},
        {"name": "dp-node4.resident", "config": "dp-node4",
         "traffic": "resident", "chips": 4}],
    "end_to_end": [{"name": "dwarf_run_s", "unit": "s",
                    "workloads": ["dp-jube.dwarf"]}],
    "per_layer": [
        {"name": n, "unit": "s", "moves": "dwarf_run_s",
         "workloads": ["dp-jube.dwarf"]}
        for n in ("device_idle.dwarf", "host_pack_s.dwarf", "h2d_s.dwarf")] + [
        {"name": "mesh_skew", "unit": "%", "moves": "columns_per_s",
         "workloads": ["dp-node4.resident"]}],
}
CELLS = [w["name"] for w in BENCH["workloads"]] + [
    w["name"] for w in PARKED["workloads"]]


def _extended() -> dict:
    bench = json.loads(json.dumps(BENCH))
    for key, entries in PARKED.items():
        bench[key] += entries
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m.get("moves", m["name"]) == "columns_per_s" and "workloads" in m \
                and m["name"] != "mesh_skew":
            m["workloads"].append("dp-node4.resident")
    return bench


@pytest.fixture
def bench(tmp_path, monkeypatch) -> dict:
    """The harness reads BENCHMARK.json with the parked cells added."""
    b = _extended()
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(run, "ROOT", tmp_path)
    return b
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]
SEED = 2**31 + 12345


def _run(capsys, argv) -> dict:
    assert run.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def _argv(cell, tiny, trace=0, seed=SEED):
    return ["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
            "--trace", str(trace), "--rehearse", tiny]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_rehearses(capsys, bench, tiny, cell, trace):
    res = _run(capsys, _argv(cell, tiny, trace))
    keys = [k for k in res if k != "breakdown"]
    assert keys == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    want = {m["name"] for m in run.cell_metrics(bench, cell, bool(trace))}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    # the rehearsal prints no device number
    assert all(m["value"] is None for m in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    assert set(res["compared"]) == {"rel_l1", "rel_max"}
    for c in res["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_without_a_card_no_result(cell):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", cell, "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_jax_loaded_means_no_result(tiny):
    code = ("import sys, types, runpy; "
            "sys.modules['cloudsc_tpu'] = types.ModuleType('cloudsc_tpu'); "
            f"sys.argv = ['run.py'] + {_argv(CELLS[0], tiny)!r}; "
            "runpy.run_path('cellbench/run.py', run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "cloudsc_tpu" in p.stderr


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copytree(PKG, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_new_files_are_found_by_name(tmp_path, tiny):
    """A new configuration, traffic mix and metric, added as files with
    entries in BENCHMARK.json, run in a checkout with no existing file
    edited."""
    shutil.copytree(PKG, tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "data").symlink_to(ROOT / "data")
    cfg = json.loads((PKG / "configs" / "dp-jube.json").read_text())
    cfg["name"] = "dp-other"
    (tmp_path / "cellbench/configs/dp-other.json").write_text(json.dumps(cfg))
    mix = json.loads((PKG / "traffic" / "resident.json").read_text())
    mix["why"] = "the resident loop under another name"
    (tmp_path / "cellbench/traffic/shared.json").write_text(json.dumps(mix))
    (tmp_path / "cellbench/metrics/units_seen.py").write_text(
        'LAYER = "device"\nMOVES = "columns_per_s"\n\n\n'
        "def read(run):\n    return float(run.units)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({**bench["configs"][0], "name": "dp-other",
                             "file": "cellbench/configs/dp-other.json"})
    bench["workloads"].append({"name": "dp-other.shared", "config": "dp-other",
                               "traffic": "shared", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "columns_per_s":
            m["workloads"].append("dp-other.shared")
    bench["per_layer"].append({"name": "units_seen", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "columns_per_s",
                               "workloads": ["dp-other.shared"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    for trace, names in ((0, {"setup_s", "columns_per_s"}),
                         (1, {"units_seen"})):
        p = subprocess.run(
            [sys.executable, "cellbench/run.py"]
            + _argv("dp-other.shared", tiny, trace), cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert res["correct"] is True
        assert set(res["metrics"]) == names


# -- faults: the timed path broken underneath, `correct` comes out false ---

def _zeros(res):
    return tuple(torch.zeros_like(r) for r in res)


def _fault(kind):
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc

    real = cc.cloudsc_fused
    calls = []

    def faulty(p, c, *args, **kwargs):
        res = real(p, c, *args, **kwargs)
        calls.append(1)
        if kind == "unchanged":        # the step returns nothing new
            return _zeros(res)
        if kind == "half":             # half the columns never computed
            for r in res:
                r[..., r.shape[-1] // 2:] = 0
            return res
        if kind == "altered":          # the temperature tendency, scaled
            res[0][:, cc.OLEV_ROWS.index("tend_t")] *= 1.5
            return res
        if kind == "share" and len(calls) % 4 == 0:   # a card's share lost
            return _zeros(res)
        return res

    return faulty


FAULTS = [(c, f) for c in CELLS if not c.startswith("dp-node4")
          for f in ("unchanged", "half", "altered")] + [
    ("dp-node4.resident", "share")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_faults_are_not_correct(capsys, monkeypatch, bench, tiny, cell,
                                fault):
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc

    monkeypatch.setattr(cc, "cloudsc_fused", _fault(fault))
    res = _run(capsys, _argv(cell, tiny))
    assert res["correct"] is False
    assert res["failed"] == 1
    assert any(c["value"] > c["limit"] for c in res["compared"].values())


@pytest.mark.parametrize("cell", ["dp-jube.resident", "sp-jube.resident"])
def test_lower_precision_control_is_not_correct(tiny, cell):
    program, control = calibrate.readings(cell, SEED, True, rehearse=tiny)
    assert program["correct"] is True
    assert control["correct"] is False
