"""The port's CLI flags beyond the single-process run, on the CPU: the
counterpart of tests/test_cli.py for `python -m cloudsc_tpu_torch`.

  * the reference-argument smoke and `--iterations` (the table equal to a
    single step's, the TOTAL row counting every step's columns);
  * `--sweep-nproma 16,25`: a config line and a perf table a value, the
    validation table once, for the last;
  * `--write-reference` to `.npz` and `.h5` against the shipped
    `data/reference.h5` at errsum/refsum < 5e-12 a field, as
    test_cli_write_reference; `--write-input` written and run back to
    outputs equal bit for bit; the CLOUDSC_WRITE_* variables; `.h5`
    without h5py raises, and nothing else is written;
  * `--debug-nans` passes on the snapshot and raises FloatingPointError
    naming the field and the step on an input poisoned with one NaN;
  * `--profile DIR` writes a Chrome trace of the timed loop;
  * `--mesh` is refused under WORLD_SIZE=2 and without a card.
"""

import contextlib
import io
import json
import re
import sys

import h5py
import numpy as np
import pytest
import torch

from cloudsc_tpu_torch import cli
from cloudsc_tpu_torch import data as tdata

from conftest import REFERENCE_H5

torch.set_num_threads(1)

BASE = ["1", "100", "16", "--device", "cpu", "--precision", "fp64"]


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _validation_rows(out):
    return [line for line in out.splitlines()
            if re.match(r" \S+\s+[123]D[123] ", line)]


@pytest.mark.parametrize("numomp", ["1", "4"])
def test_cli_serial_golden(numomp):
    rc, out = _run([numomp, *BASE[1:]])
    assert rc == 0
    assert f"NUMPROC=1, NUMOMP={numomp}, NGPTOTG=100" in out
    assert "TOTAL" in out
    assert len(_validation_rows(out)) == 21 and "!!!!" not in out


def test_cli_chained_iterations():
    """--iterations 2: the table equals a single step's; the TOTAL row
    counts both steps' columns."""
    rc, out = _run([*BASE, "--iterations", "2"])
    assert rc == 0
    _, out1 = _run(BASE)
    assert _validation_rows(out) == _validation_rows(out1)
    total = next(line for line in out.splitlines()
                 if line.rstrip().endswith(": TOTAL"))
    assert "       200" in total


def test_cli_sweep_nproma():
    rc, out = _run([*BASE, "--sweep-nproma", "16,25"])
    assert rc == 0
    cfg = [line for line in out.splitlines() if "NUMPROC=" in line]
    assert len(cfg) == 2
    assert "NPROMA=16" in cfg[0] and "NPROMA=25" in cfg[1]
    assert "NGPBLKS=7" in cfg[0] and "NGPBLKS=4" in cfg[1]
    assert sum(line.rstrip().endswith(": TOTAL")
               for line in out.splitlines()) == 2
    assert sum(line.startswith(" PLUDE") for line in out.splitlines()) == 1


@pytest.mark.parametrize("bad", ["16,x", "16,0"])
def test_cli_sweep_nproma_refuses_bad_values(bad, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([*BASE, "--sweep-nproma", bad])
    assert e.value.code == 2
    assert "--sweep-nproma" in capsys.readouterr().err


@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_cli_write_reference(tmp_path, suffix):
    path = tmp_path / f"ref_regen{suffix}"
    rc, out = _run([*BASE, "--no-validate", "--write-reference", str(path)])
    assert rc == 0 and f"wrote reference snapshot -> {path}" in out
    fields, scalars = tdata._read(path)
    assert (scalars["KLON"], scalars["KLEV"]) == (100, 137)
    with h5py.File(REFERENCE_H5) as shipped:
        for k in shipped.keys():
            if k in ("KLON", "KLEV", "KFLDX"):
                continue
            x, y = fields[k], np.asarray(shipped[k])
            assert x.shape == y.shape, k
            denom = max(np.abs(y).sum(), 1e-300)
            assert np.abs(x - y).sum() / denom < 5e-12, k


@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_cli_write_input_runs_back_bitwise(tmp_path, suffix):
    """The written input, run back through --input, gives the outputs of
    the run that wrote it, bit for bit."""
    snap, first, second = (tmp_path / f"in{suffix}", tmp_path / "a.npz",
                           tmp_path / "b.npz")
    rc, out = _run([*BASE, "--no-validate", "--write-input", str(snap),
                    "--write-reference", str(first)])
    assert rc == 0 and f"wrote input snapshot -> {snap}" in out
    fields, scalars = tdata._read(snap)
    want, _ = tdata._read(tdata.default_input_path())
    for name in tdata.INPUT_FIELDS:
        np.testing.assert_array_equal(fields[name], want[name], err_msg=name)
    assert scalars["KLON"] == 100 and scalars["PTSPHY"] == 3600.0
    rc, _ = _run([*BASE, "--no-validate", "--input", str(snap),
                  "--write-reference", str(second)])
    assert rc == 0
    a, _ = tdata._read(first)
    b, _ = tdata._read(second)
    assert a.keys() == b.keys() and len(a) == 21
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_write_variables(tmp_path, monkeypatch):
    """CLOUDSC_WRITE_INPUT and CLOUDSC_WRITE_REFERENCE stand for the
    flags (cloudsc_tpu/cli.py:249-272)."""
    monkeypatch.setenv("CLOUDSC_WRITE_INPUT", str(tmp_path / "in.npz"))
    monkeypatch.setenv("CLOUDSC_WRITE_REFERENCE", str(tmp_path / "ref.npz"))
    rc, out = _run([*BASE, "--no-validate"])
    assert rc == 0
    assert "wrote input snapshot" in out and "wrote reference" in out
    inp = tdata.load_input(tmp_path / "in.npz")
    assert inp.klon_file == 100 and inp.klev == 137
    ref = tdata.load_reference(tmp_path / "ref.npz")
    assert set(ref) == set(tdata.REFERENCE_FIELDS)


def test_write_snapshot_refuses_h5_without_h5py(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(RuntimeError, match="needs h5py"):
        tdata.write_snapshot(tmp_path / "x.h5", {"A": np.zeros(3)}, {})
    with pytest.raises(ValueError, match=".npz or .h5"):
        tdata.write_snapshot(tmp_path / "x.dat", {"A": np.zeros(3)}, {})
    assert list(tmp_path.iterdir()) == []


def test_rank_paths():
    assert cli.rank_path("out/ref.npz", 0, 1) == "out/ref.npz"
    assert cli.rank_path("out/ref.npz", 1, 2) == "out/ref.rank1.npz"
    assert cli.rank_path("ref.h5", 0, 4) == "ref.rank0.h5"


@pytest.fixture(scope="module")
def poisoned(tmp_path_factory):
    """The snapshot with one NaN in PT (level 100, column 7)."""
    fields, scalars = tdata._read(tdata.default_input_path())
    fields["PT"] = fields["PT"].copy()
    fields["PT"][100, 7] = np.nan
    path = tmp_path_factory.mktemp("nan") / "poisoned.npz"
    tdata.write_snapshot(path, fields, scalars)
    return path


@pytest.mark.parametrize("kernel", ["auto", "scan"])
def test_cli_debug_nans(poisoned, kernel):
    rc, out = _run([*BASE, "--kernel", kernel, "--debug-nans",
                    "--iterations", "2"])
    assert rc == 0 and len(_validation_rows(out)) == 21
    with pytest.raises(FloatingPointError,
                       match=r"non-finite value in \w+ after step 0"):
        _run([*BASE, "--kernel", kernel, "--debug-nans", "--input",
              str(poisoned)])


def test_check_finite_names_the_first_field():
    from cloudsc_tpu_torch.physics.cloudsc import CloudscOutputs
    from cloudsc_tpu_torch.runtime.driver import check_finite

    out = CloudscOutputs(*(torch.zeros(3) for _ in CloudscOutputs._fields))
    check_finite(out, 4)
    out.pfplsn[1] = float("inf")
    out.tendency_loc_q[2] = float("nan")
    with pytest.raises(FloatingPointError,
                       match="non-finite value in pfplsn after step 4"):
        check_finite(out, 4)


def test_cli_profile_writes_a_trace(tmp_path):
    rc, out = _run([*BASE, "--no-validate", "--profile", str(tmp_path)])
    assert rc == 0
    path = tmp_path / "trace_rank0_nproma16.json"
    assert f"profiler trace -> {path}" in out
    trace = json.loads(path.read_text())
    assert trace["traceEvents"], "empty trace"


def test_cli_mesh_refused_under_ranks(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        cli.main(["1", "100", "16", "--mesh"])
    assert e.value.code == 2
    assert "under several ranks each rank takes one card" in \
        capsys.readouterr().err


def test_cli_mesh_needs_a_card(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([*BASE, "--mesh"])
    assert e.value.code == 2
    assert "--mesh shards over the visible cards" in capsys.readouterr().err
