"""Ranks and devices of a run: the column decomposition over processes and
over the cards of one process.

Counterpart of `cloudsc_tpu/runtime/dist.py`. The reference's whole
distributed backend is a thin MPI wrapper that (a) splits the columns
between ranks at load time and (b) reduces the validation norms and
gathers the perf rows (ref: src/common/module/cloudsc_mpi_mod.F90). Here:

  * ranks are processes of `torch.distributed`, launched as `torchrun`
    launches them (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
    `MASTER_PORT`); each takes its share of NGPTOTG (`rank_share`) and
    one card (`rank_device`);
  * a mesh is a list of devices in one process (`column_devices`); the
    driver cuts its columns into contiguous shares (`split_columns`) and
    launches the kernel once a device;
  * the validation norms of several shards or ranks reduce to one table
    (`reduce_norms`, `allreduce_field_norms`), and the perf rows gather to
    every rank (`gather_perf_rows`).

The backend is gloo, on every host. The compute path has no collective:
columns are independent, as in the reference, whose compute has no MPI
call either. The only collectives are one (21, 5) fp64 norm table and one
(nranks, 2) perf gather a run, both on host arrays, where a device
backend would buy nothing. And gloo lets two ranks share one card (a
one-card host runs the two-rank case), which NCCL refuses.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as tdist

# how long a collective waits for a peer before it raises: a rank that
# died or hangs makes the others fail instead of waiting for ever
TIMEOUT = datetime.timedelta(seconds=300)


def initialize() -> bool:
    """Join the process group of a launch with WORLD_SIZE > 1 (the
    CLOUDSC_MPI_INIT analogue, ref: cloudsc_mpi_mod.F90:58-95): gloo, its
    rendezvous read from RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT.
    A no-op without WORLD_SIZE > 1, and idempotent. Returns whether a
    group is initialized. Call it before any device query."""
    if tdist.is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    tdist.init_process_group("gloo", timeout=TIMEOUT)
    return True


def finalize() -> None:
    """Leave the process group, if one was joined."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def rank_share(ngptotg: int, rank: int, nranks: int) -> int:
    """This rank's column count: ceil(NGPTOTG / nranks) each, the last rank
    the rest (ref: dwarf_cloudsc.F90:74-77; cloudsc_tpu/cli.py:130-137).
    A rank left with no columns raises."""
    share = (ngptotg - 1) // nranks + 1
    ngptot = min(share, ngptotg - rank * share)
    if ngptot < 1:
        raise ValueError(
            f"rank {rank} of {nranks} gets no columns of NGPTOTG={ngptotg} "
            f"(shares of {share}); run fewer ranks or more columns")
    return ngptot


def rank_device(device) -> torch.device:
    """The device of this rank: the CPU as asked, a card as given, or for
    plain "cuda" card LOCAL_RANK % device_count(), so every rank of a
    one-card host takes cuda:0. "cuda" without a card raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    if device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def column_devices(devices=None) -> list[torch.device]:
    """The devices of a mesh: every visible card for None, else the given
    devices (names or torch.device; a device may repeat, so one card or the
    CPU can hold a mesh of several shares). Raises without a card where a
    card is asked for."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh over the visible cards needs a CUDA "
                               "device; torch.cuda.is_available() is False")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in out}) != 1 or out[0].type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh is all cards or all CPU: {out}")
    if out[0].type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        out = [d if d.index is not None
               else torch.device("cuda", torch.cuda.current_device())
               for d in out]
    return out


def split_columns(ncol: int, n: int) -> list[tuple[int, int]]:
    """`n` contiguous (start, stop) shares of `ncol` columns, the first
    `ncol % n` one column wider (the layout `shard_fields` gives a column
    mesh). Fewer columns than shares raises."""
    if ncol < n:
        raise ValueError(f"{ncol} columns cannot fill {n} shares")
    base, extra = divmod(ncol, n)
    bounds = np.cumsum([0] + [base + (s < extra) for s in range(n)])
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


# -- validation norms: (min, max, maxerr, errsum, refsum) a field ------------

def error_norms(field: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(min, max, maxabserr, errsum, refsum) of one field against its
    reference, formed in fp64 where the tensors lie (`dist.py:237-255`'s
    `error_norms` without the mesh reduction). The field is made
    contiguous first, so the sums run in its canonical order whatever view
    it is (TENDENCY_LOC_CLD is a strided view of K1's level buffer)."""
    f, r = field.double().contiguous(), ref.double()
    d = (f - r).abs()
    return torch.stack([f.min(), f.max(), d.max(), d.sum(), r.abs().sum()])


def reduce_norms(rows) -> np.ndarray:
    """Norm rows of several shards, `(nshards, ..., 5)` (or a list of
    `(..., 5)`), reduced to one `(..., 5)` on the host: min, max, max, sum,
    sum (the pmin/pmax/psum of the JAX package's `sharded_error_norms`)."""
    g = np.asarray([np.asarray(r, np.float64) for r in rows])
    return np.stack([g[..., 0].min(axis=0), g[..., 1].max(axis=0),
                     g[..., 2].max(axis=0), g[..., 3].sum(axis=0),
                     g[..., 4].sum(axis=0)], axis=-1)


# -- collectives across ranks (CLOUDSC_MPI_REDUCE_* / GATHER analogues) -----

_NORM_OPS = (tdist.ReduceOp.MIN, tdist.ReduceOp.MAX, tdist.ReduceOp.MAX,
             tdist.ReduceOp.SUM, tdist.ReduceOp.SUM)


def allreduce_field_norms(norms) -> np.ndarray:
    """Every rank's `(nfields, 5)` fp64 norms reduced across ranks: MIN,
    MAX, MAX, SUM, SUM on the five columns (ref: validate_mod.F90:148-151;
    `dist.py:192-217`). Every rank gets the same table; in one process
    the table itself."""
    norms = np.asarray(norms, dtype=np.float64)
    if world_size() == 1:
        return norms
    cols = []
    for j, op in enumerate(_NORM_OPS):
        col = torch.from_numpy(np.ascontiguousarray(norms[:, j]))
        tdist.all_reduce(col, op=op)
        cols.append(col.numpy())
    return np.stack(cols, axis=-1)


def gather_perf_rows(seconds: float, ncols: int) -> np.ndarray:
    """One (seconds, columns) row a rank, gathered to every rank in rank
    order (ref: timer_mod.F90:167, cloudsc_mpi_mod.F90:271-329;
    `dist.py:220-234`). Returns `(nranks, 2)` fp64."""
    row = torch.tensor([float(seconds), float(ncols)], dtype=torch.float64)
    if world_size() == 1:
        return row[None, :].numpy()
    rows = [torch.empty_like(row) for _ in range(world_size())]
    tdist.all_gather(rows, row)
    return torch.stack(rows).numpy()
