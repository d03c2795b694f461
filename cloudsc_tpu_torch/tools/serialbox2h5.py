"""Serialbox archive -> snapshot file (`.h5` mirror or the port's `.npz`).

Counterpart of `cloudsc_tpu/tools/serialbox2h5.py` (the reference's
serialbox2hdf5, ref: serialbox2hdf5/serialbox2hdf5.py:25-96), numpy only:
it reads a Serialbox "Binary" directory with the port's reader and writes
its fields in the mirror layout (reversed dims, C order) and its global
scalars with `data.write_snapshot`, as `.h5` (needs h5py) or as `.npz`
(no HDF5 library needed), then reads the file back and compares.

    python -m cloudsc_tpu_torch.tools.serialbox2h5 DIR input.h5 [--prefix input]
    python -m cloudsc_tpu_torch.tools.serialbox2h5 DIR input.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..data import _read, write_snapshot
from ..data.serialbox import load_input_archive


def convert(directory, out_path, prefix: str = "input",
            verify: bool = True) -> int:
    fields, scalars = load_input_archive(directory, prefix)
    write_snapshot(out_path, fields, scalars)
    print(f"wrote {len(fields)} fields + {len(scalars)} scalars -> {out_path}")
    if verify:  # read back and compare (ref: serialbox2hdf5.py:60-77)
        back_fields, back_scalars = _read(out_path)
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
        prog="python -m cloudsc_tpu_torch.tools.serialbox2h5",
        description="Convert a Serialbox CLOUDSC archive to an .h5 mirror "
                    "or an .npz snapshot")
    p.add_argument("directory", help="Serialbox archive directory")
    p.add_argument("output", help="output .h5 or .npz path")
    p.add_argument("--prefix", default="input",
                   help="archive prefix (default: input)")
    p.add_argument("--no-verify", action="store_true")
    a = p.parse_args(argv)
    return convert(a.directory, a.output, a.prefix, verify=not a.no_verify)


if __name__ == "__main__":
    sys.exit(main())
