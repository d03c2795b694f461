"""The adjoint's memory plan, measured: seconds and peak device memory of
the full-width `pt` gradient at several column-block sizes.

    python -m cloudsc_tpu_torch.bench.grad_blocks [--ngptot 163840]
        [--blocks 32768 54614 81920] [--profile COLUMNS] [--out FILE]

For each block size: `physics.autodiff.grad` of the gradient tests' scalar
head with respect to `pt` in fp64 on the card, the host clock around it
(synchronised), the blocks it took and `torch.cuda.max_memory_allocated`;
twice, first cold (the caching allocator emptied: the first block then pays
a cudaMalloc for every 2 MB of its graph) and then warm. The fields are on
the card before the clock starts. A size that does not fit is reported as
out of memory and the sweep goes on. One forward value (`autodiff.value`)
and one `jvp`, each over every column in one block, are timed beside, for
the cost of each mode. `autodiff.DEFAULT_BLOCK_COLUMNS` is the choice made
from this sweep. `--profile COLUMNS` traces one block of that width through
the forward and the backward pass with `torch.profiler` and prints the
device's busy time beside the wall time, and the operations that take most
of it: whether the host's launch rate or the card sets the pace. GPU only:
exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# the scalar head of the gradient tests: every differentiable output head
HEAD_OUTPUTS = ("tendency_loc_t", "tendency_loc_q", "pcovptot", "pfplsl",
                "pfplsn", "pfhpsl", "pfsqlf", "plude")


def scalar_head(out, cols):
    return sum((getattr(out, n) ** 2).sum() for n in HEAD_OUTPUTS) * 1e6


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m cloudsc_tpu_torch.bench.grad_blocks",
        description=__doc__.splitlines()[0])
    p.add_argument("--ngptot", type=int, default=163840)
    p.add_argument("--blocks", type=int, nargs="+",
                   default=[32768, 54614, 81920])
    p.add_argument("--profile", type=int, default=None, metavar="COLUMNS",
                   help="trace one block of this width instead of the sweep")
    p.add_argument("--out", default=None, help="write the records as JSON")
    return p.parse_args(argv)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def profile_block(fields, params, dt, columns: int) -> dict:
    """One block's adjoint under torch.profiler: wall seconds, the device's
    busy seconds (the sum of its kernels' times) and the top operations by
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..physics import autodiff

    block = {k: v[..., :columns].contiguous() for k, v in fields.items()}

    def run():
        return autodiff.grad(scalar_head, block, params, dt, ("pt",),
                             device="cuda", block_columns=columns)

    run()  # the allocator's blocks, outside the trace
    _, plain_s, _ = _timed(run)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        _, wall_s, _ = _timed(run)
    # the device's own events only: an operator's event repeats the time
    # of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in events) * 1e-6
    launches = sum(e.count for e in events)
    print(f"profile block {columns}: {plain_s:.3f} s untraced, {wall_s:.3f} "
          f"s traced; device busy {busy_s:.3f} s in {launches} kernel "
          f"launches = {busy_s / wall_s:.3f} of the traced wall time",
          flush=True)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"  {e.self_device_time_total * 1e-6:8.3f} s {e.count:7d} x  "
              f"{e.key[:90]}", flush=True)
    return dict(mode="profile", block=columns, seconds=plain_s,
                traced_seconds=wall_s, device_busy_seconds=busy_s,
                kernel_launches=launches,
                top=[(e.key, e.self_device_time_total * 1e-6, e.count)
                     for e in top])


def main(argv=None) -> int:
    import torch

    from ..physics import autodiff
    from ..examples import load_fields
    from .timing import header, require_cuda

    args = parse_args(argv)
    if not require_cuda("grad_blocks"):
        return 1
    header("grad_blocks")
    inp, params, fields = load_fields(args.ngptot, "cuda")
    dt, kw = inp.ptsphy, dict(device="cuda")
    base = torch.cuda.memory_allocated()
    print(f"# {args.ngptot} columns fp64; fields on the card "
          f"{base / 2**30:.2f} GiB", flush=True)
    records, ref = [], None
    if args.profile:
        records.append(profile_block(fields, params, dt, args.profile))
        args.blocks = []
    for block in args.blocks:
        nblocks = -(-args.ngptot // block)
        torch.cuda.empty_cache()
        for state in ("cold", "warm"):
            try:
                g, s, peak = _timed(lambda: autodiff.grad(
                    scalar_head, fields, params, dt, ("pt",),
                    block_columns=block, **kw)["pt"])
            except torch.OutOfMemoryError:
                print(f"adjoint block {block} ({nblocks} blocks): out of "
                      f"memory", flush=True)
                records.append(dict(mode="adjoint", block=block,
                                    blocks=nblocks, oom=True))
                break
            same = None if ref is None else bool(torch.equal(g, ref))
            ref = g if ref is None else ref
            print(f"adjoint block {block} ({nblocks} blocks) {state}: "
                  f"{s:.3f} s, peak {peak / 2**30:.2f} GiB "
                  f"({(peak - base) / block / 2**20:.3f} MiB a column above "
                  f"the fields), finite {bool(torch.isfinite(g).all())}, "
                  f"equal to the first run's {same}", flush=True)
            records.append(dict(mode="adjoint", block=block, blocks=nblocks,
                                state=state, seconds=s, peak_bytes=peak,
                                equal_first=same))
            del g
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    if not args.blocks:
        return 0
    del ref
    torch.cuda.empty_cache()
    block = args.ngptot
    for state in ("cold", "warm"):
        _, s, peak = _timed(lambda: autodiff.value(
            scalar_head, fields, params, dt, **kw))
        print(f"forward, one block, {state}: {s:.3f} s, peak "
              f"{peak / 2**30:.2f} GiB", flush=True)
        records.append(dict(mode="forward", block=block, state=state,
                            seconds=s, peak_bytes=peak))
    v = torch.randn(fields["pt"].shape, dtype=torch.float64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0)) * 0.01
    _, s, peak = _timed(lambda: autodiff.jvp(
        scalar_head, fields, params, dt, {"pt": v}, **kw))
    print(f"jvp, one block: {s:.3f} s, peak {peak / 2**30:.2f} GiB",
          flush=True)
    records.append(dict(mode="jvp", block=block, seconds=s, peak_bytes=peak))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
