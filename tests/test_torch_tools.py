"""The port's archive tools (`cloudsc_tpu_torch.tools`) on the CPU, against
the JAX package's (`cloudsc_tpu.tools`).

  * `h52serialbox` from the port's `.npz` snapshot writes the same `.dat`
    bytes and the same MetaData / ArchiveMetaData JSON as the JAX tool from
    the `.h5` mirror of the same snapshot, for the input and the reference;
  * the port's loader reads the written directory equal, bit for bit, to
    the `.npz` it came from;
  * a directory converts to a directory unchanged;
  * `serialbox2h5` round-trips through `.npz` (no HDF5 library needed) and,
    where h5py is installed, through `.h5`.
"""

import filecmp
import json
from pathlib import Path

import numpy as np
import pytest

from cloudsc_tpu.tools.h52serialbox import convert as jax_h52serialbox
from cloudsc_tpu_torch import data as tdata
from cloudsc_tpu_torch.tools import h52serialbox, serialbox2h5

from conftest import REFERENCE_DATA, REFERENCE_H5

DATA = Path(__file__).resolve().parents[1] / "data"
INPUT_NPZ = str(DATA / "input.npz")
SOURCES = {"input": (INPUT_NPZ, REFERENCE_DATA),
           "reference": (str(DATA / "reference.npz"), REFERENCE_H5)}


@pytest.fixture(scope="module")
def input_archive(tmp_path_factory):
    out = tmp_path_factory.mktemp("archive")
    assert h52serialbox.main([INPUT_NPZ, str(out)]) == 0
    return out


@pytest.mark.parametrize("prefix", list(SOURCES))
def test_same_archive_as_the_jax_tool(prefix, tmp_path):
    npz, h5 = SOURCES[prefix]
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    assert h52serialbox.convert(npz, ours, prefix) == 0
    assert jax_h52serialbox(str(h5), str(theirs), prefix) == 0
    names = sorted(p.name for p in theirs.iterdir())
    assert sorted(p.name for p in ours.iterdir()) == names
    dats = [n for n in names if n.endswith(".dat")]
    assert len(dats) == {"input": 40, "reference": 21}[prefix]
    for name in dats:
        assert filecmp.cmp(ours / name, theirs / name, shallow=False), name
    for name in (f"MetaData-{prefix}.json", f"ArchiveMetaData-{prefix}.json"):
        assert json.loads((ours / name).read_text()) == \
            json.loads((theirs / name).read_text()), name


def test_loader_reads_the_archive_bitwise(input_archive):
    a = tdata.load_input(str(input_archive))
    b = tdata.load_input(INPUT_NPZ)
    assert a.scalars == b.scalars
    assert (a.klon_file, a.klev, a.ngptot, a.ptsphy) == \
        (b.klon_file, b.klev, b.ngptot, b.ptsphy)
    assert a.fields.keys() == b.fields.keys()
    for name, arr in b.fields.items():
        assert a.fields[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(a.fields[name], arr, err_msg=name)


def test_directory_to_directory(input_archive, tmp_path):
    out = tmp_path / "copy"
    assert h52serialbox.convert(input_archive, out) == 0
    for p in input_archive.iterdir():
        assert filecmp.cmp(p, out / p.name, shallow=False), p.name


@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_serialbox2h5_round_trip(suffix, input_archive, tmp_path):
    if suffix == ".h5":
        pytest.importorskip("h5py", reason="writing .h5 needs h5py, which "
                                           "is not installed")
    path = tmp_path / f"input{suffix}"
    assert serialbox2h5.main([str(input_archive), str(path)]) == 0
    fields, scalars = tdata._read(path)
    want_fields, want_scalars = tdata._read(INPUT_NPZ)
    assert scalars == want_scalars
    assert fields.keys() == want_fields.keys()
    for name, arr in want_fields.items():
        assert fields[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(fields[name], arr, err_msg=name)
