"""Copy probe: the card's read+write bandwidth against run length.

The copy kernel (K3, `out = in * 1.0000001`) copies the runs of each TPU
grid step of the JAX probe, at the same volume, as TMA bulk copies through
a ring in shared memory (`cuda_probes.COPY_RING`):

  contig<N>   one contiguous run of N*128 floats a block: the pure
              run-length curve
  strided     K1's input pattern on the TPU: block (lps, rows, SB, 128) of
              (nlev, rows, nblk, 128), lps*rows runs of SB*128 floats a
              block (--sb 1: K1's own 512-byte run a row per 128 columns)
  tilemajor   block (1, 1, lps*rows, SB, 128) of (nk2, ni, lps*rows, SB,
              128): one run of lps*rows*SB*128 floats a block, the same
              blocks and bytes as strided

Each probe's kernel output is checked bit for bit against the plain
version (`dma_copy_plain`, one PyTorch call, x * 1.0000001) on a seeded
uniform input; then both are timed: one warm-up launch, then `--iters`
back-to-back launches between CUDA events, nothing subtracted
(`ms_per_iter`, `library_ms_per_iter`). `bytes_per_iter` is the array read
and written once.

    python -m cloudsc_tpu_torch.bench.dma_probe [--iters 20] [--sb 32]
        [--lps 3] [--rows 18] [--nblk 1280] [--nlev 138]
        [--contig 32 128 512 1728 4096] [--only contig strided tilemajor]
        [--out FILE]

Exits 1 without a card, and 2 if a kernel output is not bitwise equal to
the plain version.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..kernels import cuda_probes as cp
from . import timing


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m cloudsc_tpu_torch.bench.dma_probe",
        description="Copy bandwidth against run length.")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--sb", type=int, default=32)
    p.add_argument("--lps", type=int, default=3)
    p.add_argument("--rows", type=int, default=18)
    p.add_argument("--nblk", type=int, default=1280,
                   help="column groups of 128 (1280 = 163,840 columns)")
    p.add_argument("--nlev", type=int, default=138)
    p.add_argument("--contig", type=int, nargs="+",
                   default=[32, 128, 512, 1728, 4096],
                   help="rows of 128 floats a run for the run-length curve "
                        "(x512 B: 32 -> 16 kB ... 4096 -> 2 MB)")
    p.add_argument("--only", nargs="+", default=None,
                   help="subset of probes to run (contig/strided/tilemajor)")
    p.add_argument("--out", default=None, help="write the records as JSON")
    return p.parse_args(argv)


def probes(a) -> list:
    """The probes of a run, at the JAX script's volume."""
    if a.nblk % a.sb:
        raise SystemExit(f"dma_probe: --nblk {a.nblk} is not a multiple of "
                         f"--sb {a.sb}")
    nk2, ni = a.nlev // a.lps, a.nblk // a.sb

    def want(name):
        return a.only is None or any(name.startswith(o) for o in a.only)

    out = []
    total = nk2 * ni * a.lps * a.rows * a.sb  # rows of 128 in the stream
    if want("contig"):
        out += [cp.contig_probe(cs, max(1, total // cs)) for cs in a.contig]
    if want("strided"):
        out.append(cp.strided_probe(nk2, a.lps, a.rows, a.nblk, a.sb))
    if want("tilemajor"):
        out.append(cp.tilemajor_probe(nk2, ni, a.lps, a.rows, a.sb))
    return out


def measure(probe, x, col, iters) -> dict:
    """The kernel against the plain version on (x, col), bit for bit, and
    both timed."""
    got = cp.dma_copy(x, col, probe)
    want = cp.dma_copy_plain(x, col)
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    del got, want
    ms = timing.event_ms(lambda: cp.dma_copy(x, col, probe), iters)
    lib_ms = timing.event_ms(lambda: cp.dma_copy_plain(x, col), iters)
    nbytes = int(np.prod(probe.shape)) * 4 * 2
    return dict(name=probe.name, grid=list(probe.grid),
                block=list(probe.block), run_bytes=4 * probe.run_len,
                bytes_per_iter=nbytes, bitwise=bitwise, ms_per_iter=ms,
                gb_per_s=nbytes / (ms * 1e-3) / 1e9,
                library_ms_per_iter=lib_ms,
                library_gb_per_s=nbytes / (lib_ms * 1e-3) / 1e9)


def run(a) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    col = torch.rand(cp.COL_SHAPE, device="cuda", generator=gen)
    for probe in probes(a):
        x = torch.rand(probe.shape, device="cuda", generator=gen)
        rec = measure(probe, x, col, a.iters)
        print(json.dumps(rec), flush=True)
        records.append(rec)
        del x
        torch.cuda.empty_cache()
    return records


def main(argv=None) -> int:
    a = parse_args(argv)
    if not timing.require_cuda("dma_probe"):
        return 1
    timing.header("dma_probe")
    records = run(a)
    if a.out:
        Path(a.out).write_text(json.dumps(records, indent=2))
    if not all(r["bitwise"] for r in records):
        print("dma_probe: a kernel output differs from the plain version",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
