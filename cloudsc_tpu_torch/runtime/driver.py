"""Driver: the CLOUDSC step on one device with reference-style timing.

Counterpart of `cloudsc_tpu/runtime/driver.py` for its single-process
default path (grouped + activity-sorted columns, folded pack with the
streamed ZDQS row, folded-out flux rows). Like the reference's GPU variants
it reports the kernel-only time per step, the host<->device transfers and,
as `compile_s`, the warm-up call (which builds the kernel on first use)
(ref: src/cloudsc_cuda/cloudsc/cloudsc_driver.cu, README.md:311-318).

`device="cuda"` runs the CUDA kernel and raises when there is no CUDA
device; only an explicit `device="cpu"` runs the plain PyTorch version.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data.expand import activity_perm, group_inverse
from ..kernels.cuda_cloudsc import FoldedPack, FusedStep, assemble, \
    pack_inputs_folded
from ..physics.cloudsc import CloudscOutputs
from .timer import PerformanceTimer, Timings


class CloudscDriver:
    def __init__(self, params, ptsphy: float, dtype=torch.float32,
                 device="cuda", scheme_config=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; the plain PyTorch version runs only with device='cpu'")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.params = params
        self.ptsphy = float(ptsphy)
        self.dtype = dtype
        self.scheme_config = scheme_config
        self.step = FusedStep(params, ptsphy, dtype, scheme_config).to(
            self.device)
        self._group_perm = None

    def prepare(self, inp) -> FoldedPack:
        """InputData -> the folded pack on the host, in activity-sorted
        grouped column order (data.expand.activity_perm; the identity
        layout when the snapshot is at least as wide as the run)."""
        klon = int(np.asarray(inp.fields["PT"]).shape[-1])
        self._group_perm = None
        if klon < inp.ngptot:
            self._group_perm = activity_perm(
                inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"],
                inp.ptsphy, self.params.ydecldp.rlmin,
            )
        return pack_inputs_folded(inp, self.params, self.scheme_config,
                                  self.dtype, self._group_perm)

    def ungroup(self, out: CloudscOutputs, inp) -> CloudscOutputs:
        """Gather grouped-layout outputs back to canonical (cyclic) column
        order. Copies of a snapshot column are bitwise-identical through the
        scheme, so this reconstructs the cyclic-layout outputs exactly."""
        ncol = inp.ngptot
        klon = int(np.asarray(inp.fields["PT"]).shape[-1])
        if klon >= ncol:
            return out
        inv = torch.from_numpy(
            group_inverse(klon, ncol, perm=self._group_perm).astype(np.int64)
        ).to(out.plude.device)
        return CloudscOutputs(*(a[..., inv] for a in out))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, inp, iterations: int = 1):
        """Run the scheme; returns (outputs as numpy arrays in canonical
        column order, Timings, PerformanceTimer)."""
        host = self.prepare(inp)
        timings = Timings()
        ncol = inp.ngptot

        t0 = time.perf_counter()
        p = host.to(self.device)
        self._sync()
        timings.h2d_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.step(p)
        self._sync()
        timings.compile_s = time.perf_counter() - t0

        timer = PerformanceTimer(ndevices=1)
        timer.start()
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            res = None
            start.record()
            for _ in range(iterations):
                # drop the last step's outputs first, so the caching
                # allocator reuses their blocks: a cudaMalloc inside the
                # window stalls the host long enough to idle the card
                res = None
                res = self.step(p)
            stop.record()
            stop.synchronize()
            timings.compute_s = start.elapsed_time(stop) / 1e3 / iterations
        else:
            t0 = time.perf_counter()
            for _ in range(iterations):
                res = self.step(p)
            timings.compute_s = (time.perf_counter() - t0) / iterations
        timer.end()
        timer.log(0, timings.compute_s * iterations, ncol * iterations)

        out = self.ungroup(assemble(res, p, self.step.c), inp)
        self._sync()
        t0 = time.perf_counter()
        host_out = CloudscOutputs(*(a.cpu().numpy() for a in out))
        timings.d2h_s = time.perf_counter() - t0
        return host_out, timings, timer
