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


def header(prog: str) -> None:
    """The card and the launch overhead, as comment lines."""
    print(f"# {prog} on {card()}", flush=True)
    print(f"# launch overhead: {launch_overhead_ms():.6f} ms (back-to-back "
          f"8x128 add, CUDA events; not subtracted)", flush=True)
