"""Driver: the CLOUDSC step on one device with reference-style timing.

Counterpart of `cloudsc_tpu/runtime/driver.py` for one process. Like the
reference's GPU variants it reports the step time, the host<->device
transfers and, as `compile_s`, the warm-up call (which builds the kernel on
first use) (ref: src/cloudsc_cuda/cloudsc/cloudsc_driver.cu,
README.md:311-318). Two engines (`backend`):

  * "auto" / "cuda": the fused kernel on grouped, activity-sorted columns
    (folded pack with the streamed ZDQS row, folded-out flux rows), the
    build of the configuration's own scheme version. "cuda" needs the card;
    "auto" runs the kernel's plain PyTorch version with `device="cpu"`.
  * "scan": the eager engine (`physics.cloudsc`) on the plain field dict in
    cyclic column order, padded to a multiple of NPROMA, on the driver's
    device.

A configuration the kernel does not take raises and names the scan engine,
as does a parameter that requires grad (the kernel has no backward;
`physics.autodiff` differentiates the engine); nothing falls back silently.
`device="cuda"` raises when there is no CUDA device; only an explicit
`device="cpu"` runs on the host. With EC_PMON set, `run` samples the
device's energy around the timed loop (`runtime.pmon`; a CUDA device through
NVML) into `Timings.energy_line`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data.expand import activity_perm, group_inverse
from ..kernels.cuda_cloudsc import FusedStep, assemble, check_kernel_config, \
    pack_inputs_folded, refuse_grad
from ..physics.cloudsc import CloudscOutputs, cloudsc, make_inputs
from .pmon import EnergySampler
from .timer import PerformanceTimer, Timings

BACKENDS = ("auto", "cuda", "scan")


class CloudscDriver:
    def __init__(self, params, ptsphy: float, dtype=torch.float32,
                 device="cuda", scheme_config=None, backend: str = "auto",
                 nproma: int = 128):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; the plain PyTorch version runs only with device='cpu'")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; use one of "
                             f"{BACKENDS}")
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError("backend 'cuda' runs the CUDA kernel and needs "
                             "device='cuda'")
        self.backend = backend
        self.params = params
        self.ptsphy = float(ptsphy)
        self.dtype = dtype
        self.scheme_config = scheme_config
        self.nproma = max(int(nproma), 1)
        self.step = None
        if backend != "scan":
            refuse_grad(ptsphy, *vars(params.ydecldp).values())
            self.step = FusedStep(params, ptsphy, dtype, scheme_config).to(
                self.device)
            try:
                check_kernel_config(self.step.c)
            except ValueError as e:
                raise ValueError(f"{e}; the scan engine takes any "
                                 f"configuration (backend='scan', "
                                 f"--kernel scan)") from None
        self._group_perm = None

    def prepare(self, inp):
        """InputData -> what one step consumes, on the host. The kernel: the
        folded pack in activity-sorted grouped column order
        (data.expand.activity_perm; the identity layout when the snapshot
        is at least as wide as the run). The scan engine: the plain field
        dict in cyclic order, zero-padded to a multiple of NPROMA columns
        (the padding is cut from the outputs)."""
        if self.backend == "scan":
            fields = make_inputs(inp, self.dtype)
            pad = -inp.ngptot % self.nproma
            if pad:
                fields = {k: torch.nn.functional.pad(v, (0, pad))
                          for k, v in fields.items()}
            return fields
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

    def _call(self, payload):
        if self.backend == "scan":
            return cloudsc(payload, self.params, self.ptsphy,
                           self.scheme_config)
        return self.step(payload)

    def run(self, inp, iterations: int = 1, fetch_outputs: bool = True):
        """Run the scheme; returns (outputs in canonical column order,
        Timings, PerformanceTimer). With `fetch_outputs` the outputs come
        back as numpy arrays and the D2H copy is timed; without it they
        stay on the driver's device as tensors (validate them there with
        `validate.device_field_norms`)."""
        host = self.prepare(inp)
        timings = Timings()
        ncol = inp.ngptot

        t0 = time.perf_counter()
        if self.backend == "scan":
            payload = {k: v.to(self.device) for k, v in host.items()}
        else:
            payload = host.to(self.device)
        del host
        self._sync()
        timings.h2d_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        res = self._call(payload)
        self._sync()
        timings.compile_s = time.perf_counter() - t0

        timer = PerformanceTimer(ndevices=1)
        # energy sampling around the hot loop, gated by EC_PMON like the
        # reference (ref: ec_pmon_mod.F90:14-57, cloudsc_driver_mod.F90:
        # 170-178); the loop below ends synchronised on either device
        sampler = EnergySampler(self.device)
        sampler.start()
        timer.start()
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iterations):
                # drop the last step's outputs first, so the caching
                # allocator reuses their blocks: a cudaMalloc inside the
                # window stalls the host long enough to idle the card
                res = None
                res = self._call(payload)
            stop.record()
            stop.synchronize()
            timings.compute_s = start.elapsed_time(stop) / 1e3 / iterations
        else:
            t0 = time.perf_counter()
            for _ in range(iterations):
                res = self._call(payload)
            timings.compute_s = (time.perf_counter() - t0) / iterations
        timer.end()
        timings.energy_line = sampler.stop_and_report()
        timer.log(0, timings.compute_s * iterations, ncol * iterations)

        if self.backend == "scan":
            out = CloudscOutputs(*(a[..., :ncol] for a in res))
        else:
            out = self.ungroup(assemble(res, payload, self.step.c), inp)
        del res, payload
        if not fetch_outputs:
            return out, timings, timer
        self._sync()
        t0 = time.perf_counter()
        host_out = CloudscOutputs(*(a.cpu().numpy() for a in out))
        timings.d2h_s = time.perf_counter() - t0
        return host_out, timings, timer
