"""Reader for the reference's Serialbox "Binary" archives (a directory of
`<prefix>_<FIELD>.dat` files and `MetaData-<prefix>.json`).

Counterpart of `cloudsc_tpu/data/serialbox.py` (numpy only, no Serialbox
library). The reference stores the 100-column x 137-level snapshot as raw
column-major dumps, one file a field, with shapes and types in the
MetaData JSON (ref: data/MetaData-input.json). Fields come back in the
layout of the HDF5 mirrors: reversed dims, C order, so (lev, col) and
(nclv, lev, col) (ref: serialbox2hdf5/serialbox2hdf5.py:35-48).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_ELEMENT_DTYPES = {
    ("int", 4): np.int32,
    ("int", 8): np.int64,
    ("bool", 1): np.bool_,
    ("double", 8): np.float64,
    ("float", 4): np.float32,
}


class SerialboxArchive:
    """A read-only view of one Serialbox binary archive (one savepoint)."""

    def __init__(self, directory: str | Path, prefix: str):
        self.directory = Path(directory)
        self.prefix = prefix
        with open(self.directory / f"MetaData-{prefix}.json") as f:
            self._meta = json.load(f)
        self._field_map = self._meta["field_map"]

    def fieldnames(self) -> list[str]:
        return list(self._field_map)

    def field_dims(self, name: str) -> tuple[int, ...]:
        return tuple(self._field_map[name]["dims"])

    def field_dtype(self, name: str):
        info = self._field_map[name]["meta_info"]
        return _ELEMENT_DTYPES[(info["__elementtype"]["value"],
                                info["__bytesperelement"]["value"])]

    def read(self, name: str,
             col_slice: tuple[int, int] | None = None) -> np.ndarray:
        """One field in the mirror layout. `col_slice=(start, count)` reads
        only those columns (Serialbox dim 0), through a memmap, so the
        other columns stay on disk (ref: file_io_mod.F90:158-235)."""
        dims = self.field_dims(name)
        dtype = self.field_dtype(name)
        path = self.directory / f"{self.prefix}_{name}.dat"
        n = int(np.prod(dims))
        if path.stat().st_size != n * np.dtype(dtype).itemsize:
            raise ValueError(f"{path}: expected {n} elements for dims {dims}")
        if col_slice is None:
            arr = np.fromfile(path, dtype=dtype).reshape(dims, order="F")
        else:
            start, count = col_slice
            mm = np.memmap(path, dtype=dtype, mode="r", shape=tuple(dims),
                           order="F")
            arr = np.array(mm[start:start + count])
        # column-major dims -> reversed dims in C order
        return np.ascontiguousarray(arr.transpose()) if arr.ndim > 1 else arr

    def global_scalars(self) -> dict:
        """Every global metainfo entry as a Python value."""
        return {k: rec["value"]
                for k, rec in self._meta["global_meta_info"].items()}


def load_input_archive(directory: str | Path, prefix: str = "input",
                       col_slice: tuple[int, int] | None = None
                       ) -> tuple[dict, dict]:
    """(fields, scalars) of an archive directory. `col_slice` cuts the
    per-column fields (Serialbox dim 0 == KLON) to (start, count);
    parameter tables such as RBETA stay whole."""
    ar = SerialboxArchive(directory, prefix)
    scalars = ar.global_scalars()
    klon = int(scalars.get("KLON", -1))
    fields = {name: ar.read(name, col_slice if col_slice is not None
                            and ar.field_dims(name)[0] == klon else None)
              for name in ar.fieldnames()}
    return fields, scalars
