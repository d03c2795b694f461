"""The port's bench entry (`python -m cloudsc_tpu_torch.bench.bench`) on the
CPU: the counterpart of tests/test_bench_skip.py for the JAX `bench.py`.

  * without a card it prints exactly one JSON line, `bench.py`'s skip line
    with reason "cuda_unavailable", and exits 0 (the subprocess is given no
    visible card, so this holds on any host);
  * with CLOUDSC_BENCH_CPU=1 (the caller asks for the CPU) one JSON line
    with exactly `bench.py`'s keys, a positive value and `vs_baseline` over
    the baseline that the root `bench.py` states (read as text: that file
    drives JAX);
  * CLOUDSC_BENCH_MESH=1 with CLOUDSC_BENCH_CPU_DEVICES=2 scales the
    default columns by the shares, and the metric says it is a rehearsal;
  * `config` names the route and the pack under the driver's switches;
  * two gloo ranks: rank 0 alone prints the line, over the columns of both
    ranks and the slower rank's step;
  * no fallback chain: CLOUDSC_BENCH_BACKEND=cuda on the CPU is a traceback
    and a non-zero exit with no JSON line (the JAX package's
    test_fallback_chain_survives_kernel_compile_failure holds the opposite
    for `bench.py`).
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cloudsc_tpu_torch.bench import bench
from cloudsc_tpu_torch.runtime.driver import CloudscDriver

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
KEYS = {"metric", "value", "unit", "vs_baseline", "config"}
BENCH_ENV = ("CLOUDSC_BENCH_NGPTOT", "CLOUDSC_BENCH_ITERS",
             "CLOUDSC_BENCH_BACKEND", "CLOUDSC_BENCH_PRECISION",
             "CLOUDSC_BENCH_MESH", "CLOUDSC_BENCH_CPU",
             "CLOUDSC_BENCH_CPU_DEVICES", "CLOUDSC_GROUP_COLUMNS",
             "CLOUDSC_GROUP_SORT", "CLOUDSC_FOLD_CURVES",
             "CLOUDSC_FOLD_NEWTON", "CLOUDSC_FOLD_DEP",
             "CLOUDSC_S521_ROUND_SKIP")


def _jax_baseline() -> float:
    """BASELINE_COLS_PER_S as the root bench.py writes it."""
    text = (REPO / "bench.py").read_text()
    m = re.search(r"^BASELINE_COLS_PER_S = ([0-9.e]+) / ([0-9.e]+)", text,
                  re.M)
    return float(m.group(1)) / float(m.group(2))


def _bench(extra_env):
    env = {k: v for k, v in os.environ.items() if k not in BENCH_ENV}
    env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-m", "cloudsc_tpu_torch.bench.bench"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)


@pytest.fixture
def clean_env(monkeypatch):
    for k in BENCH_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_skip_line_without_a_card():
    r = _bench({"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1, r.stdout
    rec = json.loads(lines[0])
    assert rec["skipped"] is True
    assert rec["reason"] == "cuda_unavailable"
    assert rec["unit"] == "columns/s"
    assert "last_measured" in rec
    assert rec["last_measured"] is None or rec["last_measured"]["value"] > 0


def test_cpu_line_has_bench_keys(clean_env, capsys):
    clean_env.setenv("CLOUDSC_BENCH_CPU", "1")
    clean_env.setenv("CLOUDSC_BENCH_NGPTOT", "256")
    clean_env.setenv("CLOUDSC_BENCH_ITERS", "2")
    assert bench.main() == 0
    rec = _line(capsys)
    assert set(rec) == KEYS
    assert bench.BASELINE_COLS_PER_S == _jax_baseline()
    assert rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / _jax_baseline(), 4)
    assert rec["unit"] == "columns/s"
    assert rec["config"] == "plain/grouped+fold+foldo+fn"
    assert "256 cols" in rec["metric"] and "fp32" in rec["metric"]


def test_cpu_mesh_scales_the_columns(clean_env, capsys):
    clean_env.setattr(bench, "CPU_NGPTOT", 128)
    for k, v in (("CLOUDSC_BENCH_CPU", "1"), ("CLOUDSC_BENCH_MESH", "1"),
                 ("CLOUDSC_BENCH_CPU_DEVICES", "2"),
                 ("CLOUDSC_BENCH_ITERS", "1")):
        clean_env.setenv(k, v)
    assert bench.main() == 0
    rec = _line(capsys)
    assert set(rec) == KEYS and rec["value"] > 0
    assert "256 cols" in rec["metric"]
    assert "2-share CPU mesh rehearsal" in rec["metric"]


@pytest.mark.parametrize("env,config", [
    ({}, "plain/grouped+fold+foldo+fn"),
    ({"CLOUDSC_GROUP_COLUMNS": "0"}, "plain/cyclic+fold+foldo+fn"),
    ({"CLOUDSC_FOLD_CURVES": "1", "CLOUDSC_FOLD_DEP": "1"},
     "plain/grouped+fold+foldo+fc+fn+fd"),
    ({"CLOUDSC_FOLD_NEWTON": "0"}, "plain/grouped+fold+foldo"),
], ids=["default", "cyclic", "fc_fd", "fn_off"])
def test_config_names_route_and_pack(clean_env, env, config):
    from cloudsc_tpu_torch import data
    from cloudsc_tpu_torch.params import Params

    for k, v in env.items():
        clean_env.setenv(k, v)
    inp = data.load_input(data.default_input_path(), 100)
    params = Params.from_input(inp)
    driver = CloudscDriver(params, inp.ptsphy, device="cpu")
    assert bench.config_name(driver, "plain") == config
    assert bench.default_config() == (env == {})
    scan = CloudscDriver(params, inp.ptsphy, device="cpu", backend="scan")
    assert bench.config_name(scan, "plain") == "scan/cyclic"


def test_two_ranks_print_one_line():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in BENCH_ENV}
    env.update(CLOUDSC_BENCH_CPU="1", CLOUDSC_BENCH_NGPTOT="256",
               CLOUDSC_BENCH_ITERS="1", WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cloudsc_tpu_torch.bench.bench"], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    assert outs[1].strip() == ""
    lines = outs[0].strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == KEYS and rec["value"] > 0
    assert "256 cols" in rec["metric"] and "2 ranks" in rec["metric"]


def test_no_fallback_chain():
    r = _bench({"CLOUDSC_BENCH_CPU": "1", "CLOUDSC_BENCH_BACKEND": "cuda",
                "CLOUDSC_BENCH_NGPTOT": "256", "CLOUDSC_BENCH_ITERS": "1"})
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert "fallback" not in r.stdout
    assert "Traceback" in r.stderr and "backend 'cuda'" in r.stderr
