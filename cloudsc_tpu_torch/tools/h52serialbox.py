"""Snapshot -> Serialbox "Binary" archive (the inverse of `serialbox2h5`).

Counterpart of `cloudsc_tpu/tools/h52serialbox.py`, numpy only. The source
is anything the port's loaders read: the port's `.npz` archive, an `.h5`
mirror (with h5py) or another Serialbox directory. So a host without h5py
writes an archive from `data/input.npz`. It writes what the reference
consumes (ref: src/prototype1/support/serialize_mod.F90:62-130): one
`<prefix>_<FIELD>.dat` column-major dump a field, `MetaData-<prefix>.json`
and `ArchiveMetaData-<prefix>.json` (ref: data/MetaData-input.json,
data/ArchiveMetaData-input.json, "archive_name": "Binary"), the same bytes
and JSON as the JAX tool writes from the `.h5` mirror of the same snapshot
(tests/test_torch_tools.py).

Layout: the snapshots hold fields with the Fortran dims reversed in C
order (ref: serialbox2hdf5/serialbox2hdf5.py:35-48); the `.dat` files hold
the Fortran dims column-major. Reversing the dims and the memory order
cancel out, so a field's C-order byte stream is the column-major dump.

The fields_table checksums are uppercase SHA-256 of the `.dat` bytes in
Serialbox's unpadded per-byte hex style, as the JAX tool writes them; no
reader compares them.

    python -m cloudsc_tpu_torch.tools.h52serialbox data/input.npz DIR \\
        [--prefix input] [--no-verify]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

from ..data import _read
from ..data.serialbox import load_input_archive

# Serialbox TypeID values (ref: data/MetaData-input.json type_id fields:
# LDCUM=1 bool, KTYPE=2 int32, PT=5 float64, __name=6 string)
TYPE_IDS = {
    np.dtype(np.bool_): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.float32): 4,
    np.dtype(np.float64): 5,
}
ELEMENT_NAMES = {
    np.dtype(np.bool_): "bool",
    np.dtype(np.int32): "int",
    np.dtype(np.int64): "int",
    np.dtype(np.float32): "float",
    np.dtype(np.float64): "double",
}


def scalar_entry(val) -> dict:
    """global_meta_info record for one scalar (type_id by its type)."""
    if isinstance(val, (bool, np.bool_)):
        return {"type_id": 1, "value": bool(val)}
    if isinstance(val, (int, np.integer)):
        return {"type_id": 2, "value": int(val)}
    if isinstance(val, (float, np.floating)):
        return {"type_id": 5, "value": float(val)}
    return {"type_id": 6, "value": str(val)}


def field_meta(name: str, dims: tuple, dtype: np.dtype) -> dict:
    """field_map record in the shape of the reference archive's
    meta_info, its keys sorted as the reference file sorts them."""
    sizes = list(dims) + [0] * (4 - len(dims))
    mi = {
        "__bytesperelement": {"type_id": 2, "value": int(dtype.itemsize)},
        "__elementtype": {"type_id": 6, "value": ELEMENT_NAMES[dtype]},
    }
    for axis, size in zip("ijkl", sizes):
        mi[f"__{axis}minushalosize"] = {"type_id": 2, "value": 0}
        mi[f"__{axis}plushalosize"] = {"type_id": 2, "value": 0}
        mi[f"__{axis}size"] = {"type_id": 2, "value": int(size)}
    mi["__name"] = {"type_id": 6, "value": name}
    mi["__rank"] = {"type_id": 2, "value": len(dims)}
    return {"dims": [int(d) for d in dims], "meta_info": dict(sorted(mi.items())),
            "type_id": TYPE_IDS[dtype]}


def checksum(data: bytes) -> str:
    """Unpadded per-byte uppercase hex of the SHA-256 digest."""
    return "".join(f"{b:X}" for b in hashlib.sha256(data).digest())


def read_snapshot(path, prefix: str = "input") -> tuple[dict, dict]:
    """(fields, scalars) of an `.npz` or `.h5` snapshot or a Serialbox
    directory (read with `prefix`)."""
    if Path(path).is_dir():
        return load_input_archive(path, prefix)
    return _read(path)


def write_archive(out_dir, fields: dict, scalars: dict,
                  prefix: str = "input") -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    field_map, fields_table = {}, {}
    for name in sorted(fields):
        arr = np.asarray(fields[name])
        dims = tuple(reversed(arr.shape)) if arr.ndim > 1 else arr.shape
        raw = np.ascontiguousarray(arr).tobytes()
        (out / f"{prefix}_{name}.dat").write_bytes(raw)
        field_map[name] = field_meta(name, dims, arr.dtype)
        fields_table[name] = [[0, checksum(raw)]]
    meta = {
        "field_map": field_map,
        "global_meta_info": {k: scalar_entry(scalars[k])
                             for k in sorted(scalars)},
        "prefix": prefix,
        "savepoint_vector": {
            "fields_per_savepoint": [
                {prefix: {name: 0 for name in sorted(fields)}}],
            "savepoints": [{"meta_info": None, "name": prefix}],
        },
        "serialbox_version": 255,
    }
    with open(out / f"MetaData-{prefix}.json", "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    archive = {
        "archive_name": "Binary",
        "archive_version": 0,
        "fields_table": fields_table,
        "serialbox_version": 255,
    }
    with open(out / f"ArchiveMetaData-{prefix}.json", "w") as f:
        json.dump(archive, f, indent=1, sort_keys=True)


def convert(src, out_dir, prefix: str = "input", verify: bool = True) -> int:
    fields, scalars = read_snapshot(src, prefix)
    write_archive(out_dir, fields, scalars, prefix)
    print(f"wrote {len(fields)} fields + {len(scalars)} scalars -> {out_dir}/")
    if verify:  # re-read with the port's reader and compare to the source
        back_fields, back_scalars = load_input_archive(out_dir, prefix)
        for name, arr in fields.items():
            if not np.array_equal(back_fields[name], arr):
                print(f"VERIFY FAILED for field {name}", file=sys.stderr)
                return 1
        for name, val in scalars.items():
            if back_scalars[name] != val:
                print(f"VERIFY FAILED for scalar {name}", file=sys.stderr)
                return 1
        print("verify pass: OK")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cloudsc_tpu_torch.tools.h52serialbox",
        description="Write a snapshot (.npz, .h5 or a Serialbox directory) "
                    "as a Serialbox Binary archive")
    p.add_argument("input", help="source .npz, .h5 or archive directory")
    p.add_argument("outdir", help="output archive directory")
    p.add_argument("--prefix", default="input",
                   help="archive prefix (default: input)")
    p.add_argument("--no-verify", action="store_true")
    a = p.parse_args(argv)
    return convert(a.input, a.outdir, a.prefix, verify=not a.no_verify)


if __name__ == "__main__":
    sys.exit(main())
