"""BENCHMARK.json against the benchmark's contract, every metric against
its reader, and the trace reduction on a synthetic trace."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from cellbench import loops, run, trace

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cellbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_and_cells():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert set(names) == used
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("cellbench/configs/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]
    cells = [w["name"] for w in BENCH["workloads"]]
    assert len(set(cells)) == len(cells)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(cells)
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= 1
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (PKG / "traffic" / f"{w['traffic']}.json").exists()
        cfg = json.loads((PKG / "configs" / f"{w['config']}.json").read_text())
        assert cfg["chips"] == w["chips"]


def test_metrics_and_their_readers():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert _line(m["layer"])
        for c in m.get("workloads", []):
            reported = run.cell_metrics(BENCH, c, False)
            assert m["moves"] in {r["name"] for r in reported}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        reader = run.load_reader(m["name"])
        assert reader.MOVES == m.get("moves", m["name"])
        if "layer" in m:
            assert reader.LAYER == m["layer"]
    # every cell reports setup_s, one more end-to-end and one per-layer
    for c in cells:
        e = {m["name"] for m in run.cell_metrics(BENCH, c, False)}
        assert "setup_s" in e and len(e) >= 2
        assert run.cell_metrics(BENCH, c, True)


def test_trace_reduce_on_a_synthetic_trace():
    cpu = [(0.0, 10.0, trace.WINDOW),
           (1.0, 4.0, "cellbench.step"), (1.5, 2.5, "aten::copy_"),
           (5.0, 9.0, "cellbench.assemble")]
    device = {0: [(0.5, 1.0, "k1"), (2.0, 3.0, "k1"), (2.5, 3.5, "copy"),
                  (9.5, 11.0, "k1")],
              1: [(0.0, 5.0, "k1")]}
    s = trace.reduce(cpu, device, units=2)
    assert s.window_s == 10.0
    # card 0: 0.5 + 1.5 (overlap merged) + 0.5 (clipped at the window)
    assert s.busy_s == [2.5, 5.0]
    assert s.device_s == [3.0, 5.0]
    assert s.device_ops[0] == ["k1", 7.0]
    labels = dict(s.idle_gaps)
    # card 0's gap (1.0, 2.0) at 1.5: inside the copy within the step span
    assert labels["cellbench.step/aten::copy_"] == pytest.approx(0.5)
    # card 0's (3.5, 9.5) and card 1's (5, 10), both in assemble
    assert labels["cellbench.assemble"] == pytest.approx((6.0 + 5.0) / 2)
    # card 0's (0, 0.5): in the window span alone
    assert labels["python"] == pytest.approx(0.5 / 2)


def test_idle_share_reads_the_window_steps():
    sl = trace.Slice(window_s=9.0, busy_s=[0.02], device_s=[0.02],
                     device_ops=[], idle_gaps=[], units=2)
    rec = loops.Record(
        loop="resident", chips=2, columns_per_chip=1, levels=137,
        precision="fp64", setup_s=1.0, window_s=1.0, units=4,
        unit_ms=[[20.0, 20.0, 90.0, 20.0], [10.0, 30.0, 20.0, 20.0]],
        spans={}, h2d_s=[], slice=sl)
    assert rec.step_ms == [20.0, 30.0, 90.0, 20.0]
    assert rec.idle_share() == pytest.approx(1.0 - 0.010 / 0.025)
    assert loops.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == \
        pytest.approx(4.8)


def test_result_line_is_strict_json():
    from cellbench.run import strict

    line = {"compared": {"rel_l1": {"value": float("inf"), "limit": 1e-7}},
            "breakdown": {"device_ops": [["k1", float("nan")], ["k2", 0.5]]}}
    text = json.dumps(strict(line), allow_nan=False)
    assert json.loads(text)["compared"]["rel_l1"]["value"] is None
    assert json.loads(text)["breakdown"]["device_ops"][1] == ["k2", 0.5]
