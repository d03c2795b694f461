"""The port's data layer (cloudsc_tpu_torch.data) against the JAX
package's (cloudsc_tpu.data), on the CPU:

  * a Serialbox directory, written from data/input.h5 by
    cloudsc_tpu/tools/h52serialbox.py: the port reads it as the JAX loader
    does (`load_input(dir, expand=False)`) and as the port reads
    data/input.npz, every field and scalar bit for bit;
  * `get_offsets` equals the JAX one over a grid of arguments;
  * per-rank loading, as tests/test_data.py::test_per_rank_slicing, on a
    256-column archive written by the test: ranks 0 and 1 of 2 get the two
    halves of the file, equal to the JAX loaders', for `load_input` from
    each format the port reads and for `load_reference`;
  * `python -m cloudsc_tpu_torch ... --input DIR` prints the validation
    table it prints with the .npz.

Tolerance 0 throughout: the loaders copy and slice; nothing is computed.
"""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cloudsc_tpu import data as jdata
from cloudsc_tpu.data import expand as jexpand
from cloudsc_tpu.tools import h52serialbox
from cloudsc_tpu_torch import data as tdata
from cloudsc_tpu_torch.data import expand as texpand

ROOT = Path(__file__).resolve().parents[1]
INPUT_H5 = ROOT / "data" / "input.h5"
REFERENCE_H5 = ROOT / "data" / "reference.h5"


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def serialbox_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("serialbox")
    assert h52serialbox.convert(str(INPUT_H5), str(out), verify=False) == 0
    return out


def test_serialbox_dir_equals_jax_and_npz(serialbox_dir):
    got = tdata.load_input(serialbox_dir)
    want = jdata.load_input(serialbox_dir, expand=False)
    npz = tdata.load_input(ROOT / "data" / "input.npz")
    _assert_same(got.fields, want.fields)
    _assert_same(got.fields, npz.fields)
    assert got.scalars == want.scalars == npz.scalars
    assert len(got.scalars) == 173
    for a in ("klon_file", "klev", "ngptot", "ptsphy"):
        assert getattr(got, a) == getattr(want, a) == getattr(npz, a), a
    # the reader on its own: one field's columns through the memmap
    ar = tdata.SerialboxArchive(serialbox_dir, "input")
    np.testing.assert_array_equal(ar.read("PT", (30, 20)),
                                  npz.fields["PT"][:, 30:50])


def test_get_offsets_equals_jax():
    for klon, ngptot, ngptotg, nranks in itertools.product(
            (1, 7, 100, 256), (1, 50, 100, 128, 300), (1, 100, 256, 1000),
            (1, 2, 3, 4)):
        for rank in range(nranks):
            args = (klon, ngptot, ngptotg, rank, nranks)
            assert texpand.get_offsets(*args) == jexpand.get_offsets(*args), \
                args


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """A 256-column input (.h5, .npz, Serialbox directory) and reference
    (.h5, .npz), the snapshot's columns tiled, KLON = 256."""
    d = tmp_path_factory.mktemp("big")
    src = jdata.load_input(INPUT_H5, ngptot=256)
    jdata.write_h5(d / "input.h5", src.fields, dict(src.scalars, KLON=256))
    tdata.write_npz(d / "input.h5", d / "input.npz")
    assert h52serialbox.convert(str(d / "input.h5"), str(d / "input"),
                                verify=False) == 0
    jdata.write_h5(d / "reference.h5",
                   jdata.load_reference(REFERENCE_H5, ngptot=256))
    tdata.write_npz(d / "reference.h5", d / "reference.npz")
    return d


@pytest.mark.parametrize("fmt", ["input.npz", "input.h5", "input"])
def test_per_rank_slicing(big, fmt):
    full = tdata.load_input(big / fmt, ngptot=256)
    assert full.fields["PT"].shape[-1] == 256
    for rank in (0, 1):
        got = tdata.load_input(big / fmt, ngptot=128, ngptotg=256,
                               rank=rank, nranks=2)
        want = jdata.load_input(big / "input.h5", ngptot=128, ngptotg=256,
                                rank=rank, nranks=2)
        _assert_same(got.fields, want.fields)
        assert got.klon_file == want.klon_file == 256
        half = slice(128 * rank, 128 * (rank + 1))
        for name in ("PT", "PAPH", "PCLV", "KTYPE", "LDCUM"):
            np.testing.assert_array_equal(got.fields[name],
                                          full.fields[name][..., half])
        # parameter tables are never sliced
        np.testing.assert_array_equal(got.fields["YRECLDP_RBETA"],
                                      full.fields["YRECLDP_RBETA"])


@pytest.mark.parametrize("fmt", ["reference.npz", "reference.h5"])
def test_per_rank_reference(big, fmt):
    full = tdata.load_reference(big / fmt, ngptot=256)
    for rank in (0, 1):
        got = tdata.load_reference(big / fmt, ngptot=128, ngptotg=256,
                                   rank=rank, nranks=2)
        want = jdata.load_reference(big / "reference.h5", ngptot=128,
                                    ngptotg=256, rank=rank, nranks=2)
        _assert_same(got, want)
        half = slice(128 * rank, 128 * (rank + 1))
        for name in ("PLUDE", "PFPLSN", "TENDENCY_LOC_CLD"):
            np.testing.assert_array_equal(got[name], full[name][..., half])


def test_defaults_unchanged_by_rank_arguments():
    """A file smaller than NGPTOTG: every rank reads all of it, as one rank
    does, and the reference expands as it did without rank arguments."""
    path = tdata.default_input_path()
    one = tdata.load_input(path, 300)
    r1 = tdata.load_input(path, 150, ngptotg=300, rank=1, nranks=2)
    _assert_same(r1.fields, one.fields)
    ref = tdata.load_reference(tdata.default_reference_path(), 300)
    raw = tdata.load_reference(tdata.default_reference_path())
    for name, arr in ref.items():
        np.testing.assert_array_equal(arr, np.concatenate(
            [raw[name]] * 3, axis=-1))


def _cli_table(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "cloudsc_tpu_torch", "1", "100", "16",
         "--device", "cpu", "--precision", "fp64", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    head = next(i for i, s in enumerate(lines) if s.startswith(" Variable"))
    return lines[head:]


def test_cli_input_dir_prints_the_npz_table(serialbox_dir):
    table = _cli_table(["--input", str(serialbox_dir)])
    assert len(table) == 22
    assert table == _cli_table([])
