"""The input snapshot and its golden outputs.

Counterpart of `cloudsc_tpu/data/io.py`. The port reads the 100-column
snapshot and the golden outputs from numpy archives (`data/input.npz`,
`data/reference.npz`, written from the `.h5` mirrors by
`python -m cloudsc_tpu_torch.data`), so a GPU host needs no HDF5 library; an
`.h5` mirror is read with h5py where it is installed, and a directory as
the reference's raw Serialbox archive (`serialbox.py`, numpy only). Arrays
keep the mirror's layout: (lev, col), (nclv, lev, col), (lev+1, col),
columns last. Both loaders take the JAX loaders' per-rank arguments
(`ngptotg`, `rank`, `nranks`; `expand.get_offsets`). `write_snapshot`
writes an input or a reference back, as `.npz` or `.h5`.

tests/test_torch_driver.py and tests/test_torch_data.py hold the loaders
equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

from .expand import expand_field, get_offsets
from .serialbox import SerialboxArchive, load_input_archive

# Input fields consumed by the scheme, in the reference load order
# (ref: cloudsc_global_state_mod.F90:188-227).
INPUT_FIELDS = [
    "PLCRIT_AER", "PICRIT_AER", "PRE_ICE", "PCCN", "PNICE",
    "PT", "PQ",
    "PVFA", "PVFL", "PVFI", "PDYNA", "PDYNL", "PDYNI",
    "PHRSW", "PHRLW", "PVERVEL", "PAP", "PAPH",
    "PLSM", "LDCUM", "KTYPE",
    "PLU", "PLUDE", "PSNDE", "PMFU", "PMFD",
    "PA", "PCLV", "PSUPSAT",
    "TENDENCY_CML_T", "TENDENCY_CML_Q", "TENDENCY_CML_A", "TENDENCY_CML_CLD",
    "TENDENCY_TMP_T", "TENDENCY_TMP_Q", "TENDENCY_TMP_A", "TENDENCY_TMP_CLD",
]

# Validated output datasets, in the reference validation order
# (ref: cloudsc_global_state_mod.F90:324-345).
REFERENCE_FIELDS = [
    "PLUDE", "PCOVPTOT", "PRAINFRAC_TOPRFZ",
    "PFSQLF", "PFSQIF", "PFCQLNG", "PFCQNNG",
    "PFSQRF", "PFSQSF", "PFCQRNG", "PFCQSNG",
    "PFSQLTUR", "PFSQITUR",
    "PFPLSL", "PFPLSN", "PFHPSL", "PFHPSN",
    "TENDENCY_LOC_A", "TENDENCY_LOC_Q", "TENDENCY_LOC_T", "TENDENCY_LOC_CLD",
]

_REPO_DATA = Path(__file__).resolve().parents[2] / "data"
_SCALARS_KEY = "__scalars__"


@dataclasses.dataclass
class InputData:
    """The unexpanded snapshot: fields at file width + global scalars. The
    consumer (the host pack) expands to `ngptot` columns."""

    fields: dict          # name -> np.ndarray, trailing axis = file columns
    scalars: dict         # the archive's global scalars
    klon_file: int        # columns in the snapshot (100)
    klev: int             # vertical levels (137)
    ngptot: int           # column count of the run
    ptsphy: float         # physics timestep


def default_input_path() -> str:
    return os.environ.get("CLOUDSC_INPUT") or str(_REPO_DATA / "input.npz")


def default_reference_path() -> str:
    return os.environ.get("CLOUDSC_REFERENCE") or str(_REPO_DATA / "reference.npz")


def _read_h5(path) -> tuple[dict, dict]:
    import h5py

    fields, scalars = {}, {}
    with h5py.File(path, "r") as f:
        for k in f.keys():
            if f[k].shape == (1,):
                v = f[k][0]
                scalars[k] = v.item() if hasattr(v, "item") else v
            else:
                fields[k] = np.asarray(f[k])
    return fields, scalars


def _read_npz(path) -> tuple[dict, dict]:
    with np.load(path, allow_pickle=False) as z:
        fields = {k: z[k] for k in z.files if k != _SCALARS_KEY}
        scalars = json.loads(str(z[_SCALARS_KEY])) if _SCALARS_KEY in z.files \
            else {}
    return fields, scalars


# parameter tables stored as fields, not per-column data: never sliced or
# expanded (ref: yoecldp.F90:358-366 loads YRECLDP_RBETA(0:100))
_TABLES = ("YRECLDP_RBETA", "YRECLDP_RBETAP1")


def _read(path, col_slice: tuple[int, int] | None = None
          ) -> tuple[dict, dict]:
    """(fields, scalars) of a Serialbox directory, an .npz archive or an
    .h5 mirror; `col_slice=(start, count)` cuts the per-column fields to
    those file columns. A directory reads only the slice (a memmap a
    field); an .npz or .h5 file is read whole and then sliced."""
    if Path(path).is_dir():
        return load_input_archive(path, "input", col_slice=col_slice)
    fields, scalars = (_read_npz if str(path).endswith(".npz")
                       else _read_h5)(path)
    if col_slice is not None:
        start, count = col_slice
        klon = int(scalars["KLON"])
        fields = {k: v[..., start:start + count]
                  if v.shape[-1] == klon and k not in _TABLES else v
                  for k, v in fields.items()}
    return fields, scalars


def _peek_klon(path) -> int:
    """The snapshot's column count, read without the fields."""
    if Path(path).is_dir():
        return int(SerialboxArchive(path, "input").global_scalars()["KLON"])
    if str(path).endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return int(json.loads(str(z[_SCALARS_KEY]))["KLON"])
    import h5py

    with h5py.File(path, "r") as f:
        return int(f["KLON"][0])


def load_input(path, ngptot: int | None = None, ngptotg: int | None = None,
               rank: int = 0, nranks: int = 1) -> InputData:
    """The input snapshot at file width, for a run of `ngptot` columns.

    `path` is an .npz archive, an .h5 mirror or the reference's Serialbox
    directory. In a run over several ranks pass this rank's `rank`, the
    rank count `nranks` and the global column count `ngptotg`: the fields
    then hold this rank's slice of the file's columns when the file has at
    least `ngptotg` of them, and the whole file otherwise
    (`expand.get_offsets`; the JAX loader's rule). The slice is taken
    before any expansion; a directory reads only the slice, an .npz or .h5
    file is loaded whole and then sliced. `klon_file` stays the file's
    column count. The defaults read the whole file."""
    klon = _peek_klon(path)
    ngptot = ngptot or klon
    start, count = get_offsets(klon, ngptot, ngptotg or ngptot, rank, nranks)
    raw, scalars = _read(path, None if (start, count) == (0, klon)
                         else (start, count))
    fields = {name: raw[name] for name in INPUT_FIELDS}
    fields.update({name: raw[name] for name in _TABLES if name in raw})
    return InputData(
        fields=fields, scalars=scalars, klon_file=klon,
        klev=int(scalars["KLEV"]), ngptot=ngptot,
        ptsphy=float(scalars["PTSPHY"]),
    )


def load_reference(path, ngptot: int | None = None,
                   ngptotg: int | None = None, rank: int = 0,
                   nranks: int = 1) -> dict:
    """The golden outputs, expanded cyclically to `ngptot` columns (at file
    width if None). With `ngptotg`, `rank` and `nranks` the file's columns
    are sliced first by the same rule as `load_input`'s, so each rank holds
    the golden columns of its own slice."""
    raw, _ = _read(path)
    out = {}
    for name in REFERENCE_FIELDS:
        arr = raw[name]
        if ngptot is not None:
            klon = arr.shape[-1]
            start, count = get_offsets(klon, ngptot, ngptotg or ngptot,
                                       rank, nranks)
            if (start, count) != (0, klon):
                arr = arr[..., start:start + count]
            arr = expand_field(arr, ngptot)
        out[name] = arr
    return out


def write_snapshot(path, fields: dict, scalars: dict) -> None:
    """Write fields and scalars as an archive both loaders read back:
    `.npz` in the port's format (every field an array, the scalars as
    JSON), `.h5` as the mirrors hold them (a dataset a field, a shape-(1,)
    dataset a scalar; needs h5py, and raises without it rather than write
    another format). Any other suffix raises."""
    path = str(path)
    if path.endswith(".npz"):
        np.savez_compressed(path, **{k: np.asarray(v)
                                     for k, v in fields.items()},
                            **{_SCALARS_KEY: np.array(json.dumps(scalars))})
        return
    if not path.endswith(".h5"):
        raise ValueError(f"{path}: a snapshot is written as .npz or .h5")
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(f"{path}: writing .h5 needs h5py, which is not "
                           f"installed; write .npz instead") from e
    with h5py.File(path, "w") as f:
        for k, v in fields.items():
            f.create_dataset(k, data=np.asarray(v))
        for k, v in scalars.items():
            f.create_dataset(k, data=np.asarray([v]))


def write_npz(h5_path, npz_path) -> None:
    """Convert an .h5 mirror (input or reference) to the port's archive:
    every non-scalar dataset as an array, the shape-(1,) scalars as JSON."""
    write_snapshot(npz_path, *_read_h5(h5_path))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m cloudsc_tpu_torch.data IN.h5 OUT.npz",
              file=sys.stderr)
        return 2
    write_npz(argv[0], argv[1])
    return 0
