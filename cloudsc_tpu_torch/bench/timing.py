"""Timing for the lab's entry points: CUDA events around back-to-back
launches, the card's name and power limit, and the refusal to run without a
card."""

from __future__ import annotations

import subprocess
import sys

import torch


def require_cuda(prog: str) -> bool:
    """True when a CUDA device is present; otherwise says so on stderr (the
    caller exits 1: a plain version on the CPU is not a measurement)."""
    if torch.cuda.is_available():
        return True
    print(f"{prog}: torch.cuda.is_available() is False; this measurement "
          f"needs a CUDA device", file=sys.stderr)
    return False


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def event_ms(fn, iters: int, warmup: int = 1) -> float:
    """Milliseconds per call of `fn`: `warmup` calls, then `iters` calls
    back to back between two CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def launch_overhead_ms(iters: int = 100) -> float:
    """Milliseconds per back-to-back launch of an empty-sized torch add
    (one 8x128 fp32 tensor), for information: nothing is subtracted."""
    x = torch.zeros((8, 128), device="cuda")
    return event_ms(lambda: x.add_(0.0), iters)


# The bound's model (chip_smoke.py, the lab's records). The assumed HBM peak
# of one H100 SXM (NVIDIA data sheet) at 700 W: a share against it is a
# modeled byte count over this figure, not a measured rate. Its assumed
# non-tensor-core peaks, flop/s. K1's operations: the reference's flop
# model (timer_mod.F90: 12,482,329 per 100 columns).
PEAK_GBS = 3350.0
PEAK_FLOPS = {"fp32": 67e12, "fp64": 34e12}
K1_FLOP_PER_COLUMN = 12482329 / 100


def bound(nbytes: float, flops: float, precision: str) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over PEAK_GBS and the operations over
    PEAK_FLOPS[precision]."""
    t_bytes = nbytes / (PEAK_GBS * 1e9) * 1e3
    t_ops = flops / PEAK_FLOPS[precision] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def header(prog: str) -> None:
    """The card and the launch overhead, as comment lines."""
    print(f"# {prog} on {card()}", flush=True)
    print(f"# launch overhead: {launch_overhead_ms():.6f} ms (back-to-back "
          f"8x128 add, CUDA events; not subtracted)", flush=True)
