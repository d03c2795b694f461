"""Driver: the CLOUDSC step on one device or a column mesh, with
reference-style timing.

Counterpart of `cloudsc_tpu/runtime/driver.py`. Like the reference's GPU
variants it reports the step time, the host<->device transfers and, as
`compile_s`, the warm-up call (which builds the kernel on first use) (ref:
src/cloudsc_cuda/cloudsc/cloudsc_driver.cu, README.md:311-318). Two engines
(`backend`):

  * "auto" / "cuda": the fused kernel on the input pack, the build of the
    configuration's own version, the pack's form and the output rows.
    "cuda" needs the card; "auto" runs the kernel's plain PyTorch version
    with `device="cpu"`. The JAX driver's switches, read once at
    construction, choose the payload: CLOUDSC_PACKED_STORAGE (default 1:
    the pack built on the host; 0: the plain field dict of the scan
    engine, padded as it pads, which each step reads in place, with no
    pack, `cuda_cloudsc.cloudsc_fused` on the dict: the per-field entry,
    whose build streams the ZDQS row zdqs_kernel writes from the dict);
    the pack's form from CLOUDSC_FOLD_INPUTS (default 1: section 1's state
    sums and the summed pairs folded in fp64 on the host; 0: the unfolded
    pack, the kernel forming them, with the in-line CUADJTQ),
    CLOUDSC_FOLD_NEWTON (default 1: the streamed ZDQS row; 0: the
    kernel's in-line CUADJTQ), CLOUDSC_FOLD_CURVES and CLOUDSC_FOLD_DEP
    (default 0: the saturation curves and the deposition chain computed in
    the kernel); the output rows from CLOUDSC_FOLD_OUTPUTS (default 1: the
    four derivable flux rows rebuilt after the step; 0: written by the
    kernel); and the pack's column layout from CLOUDSC_GROUP_COLUMNS
    (default 1: each snapshot column's copies together; 0: the cyclic
    order of the reference's expansion) and CLOUDSC_GROUP_SORT (default 1:
    grouped columns in activity order; 0: in source order). The outputs
    come back in the canonical (cyclic) order whatever the layout.
  * "scan": the eager engine (`physics.cloudsc`) on the plain field dict in
    cyclic column order, padded to a multiple of NPROMA, on the driver's
    device; with CLOUDSC_SCAN_PACKED=1 (default 0) the dict is stacked
    once on each device after the copy (`physics.cloudsc.scan_pack`),
    outside the timed loop.

A mesh (`devices=[...]`, or `mesh=True` for every visible card) cuts the
columns into contiguous shares, one a device (`dist.split_columns`): the
kernel's pack in activity order dealt over the shards
(`activity_perm(nshards=)`), the scan engine's padded dict (padded to a
multiple of lcm(NPROMA, devices)). Each device runs its share with no host
sync between the devices, and is timed by its own CUDA events, one timer
row a device. A device may repeat (one card, or the CPU, holding several
shares). A mesh of one device is the one-device path.

A configuration the kernel does not take raises and names the scan engine,
as does a parameter that requires grad (the kernel has no backward;
`physics.autodiff` differentiates the engine); nothing falls back silently.
`device="cuda"` raises when there is no CUDA device; only an explicit
`device="cpu"` runs on the host. With EC_PMON set, `run` samples the
first device's energy around the timed loop (`runtime.pmon`; a CUDA device
through NVML) into `Timings.energy_line`.

`run` records its phases as spans of `runtime.tracing`: `cloudsc.prepare`
(the host pack), `cloudsc.shard` (H2D and a sync), `cloudsc.warmup` (the
first call and a sync), `cloudsc.loop` (the timed loop), `cloudsc.ungroup`
(the canonical order) and, when the outputs are fetched, `cloudsc.fetch`
(D2H); `Timings.h2d_s`, `compile_s` and `d2h_s` are the durations of
`cloudsc.shard`, `cloudsc.warmup` and `cloudsc.fetch`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time

import numpy as np
import torch

from ..data.expand import activity_perm, group_inverse
from ..kernels.cuda_cloudsc import FoldedPack, FusedStep, assemble, \
    check_kernel_config, fold_flags, fold_outputs_flag, pack_inputs_raw, \
    refuse_grad
from ..physics.cloudsc import CloudscOutputs, cloudsc, make_inputs, \
    scan_pack
from . import dist, tracing
from .pmon import EnergySampler
from .timer import PerformanceTimer, Timings

BACKENDS = ("auto", "cuda", "scan")


def check_finite(out: CloudscOutputs, step: int) -> None:
    """Raise FloatingPointError naming the first of the 21 fields (in
    CloudscOutputs order) that holds a NaN or an infinity after `step`;
    one `isfinite` reduction a field where the field lies."""
    for name, a in zip(out._fields, out):
        if not bool(torch.isfinite(a).all()):
            raise FloatingPointError(
                f"non-finite value in {name} after step {step}")


class CloudscDriver:
    def __init__(self, params, ptsphy: float, dtype=torch.float32,
                 device="cuda", scheme_config=None, backend: str = "auto",
                 nproma: int = 128, devices=None, mesh: bool = False):
        if mesh and devices is not None:
            raise ValueError("give devices or mesh=True, not both")
        if mesh or devices is not None:
            self.devices = dist.column_devices(devices)
        else:
            self.devices = [torch.device(device)]
        self.device = self.devices[0]
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
        # the JAX driver's switches, read once here: the payload (a pack,
        # or a field dict: the scan engine's, or the kernel's without
        # packed storage), the pack's form and column layout, the output
        # rows
        kernel = backend != "scan"
        self.packed = kernel and \
            os.environ.get("CLOUDSC_PACKED_STORAGE", "1") != "0"
        self.scan_packed = not kernel and \
            os.environ.get("CLOUDSC_SCAN_PACKED", "0") == "1"
        self.form = fold_flags()
        self.fold_outputs = fold_outputs_flag()
        self.grouped = self.packed and \
            os.environ.get("CLOUDSC_GROUP_COLUMNS", "1") != "0"
        self.group_sort = self.grouped and \
            os.environ.get("CLOUDSC_GROUP_SORT", "1") != "0"
        self.step = None
        if kernel:
            refuse_grad(ptsphy, *vars(params.ydecldp).values())
            self.step = FusedStep(params, ptsphy, dtype, scheme_config,
                                  self.fold_outputs).to(self.device)
            try:
                check_kernel_config(self.step.c)
            except ValueError as e:
                raise ValueError(f"{e}; the scan engine takes any "
                                 f"configuration (backend='scan', "
                                 f"--kernel scan)") from None
        self._group_perm = None
        # the payload's column shares, [(start, stop)] (`shard`), and the
        # last run's outputs', [(device, (start, stop))] in canonical order
        self.shares = None
        self.out_shares = None

    @property
    def ndevices(self) -> int:
        return len(self.devices)

    def config_name(self, route: str) -> str:
        """`route/payload`, naming what the switches chose: the eager
        engine's cyclic field dict (`scan/cyclic`, `+packed` stacked by
        `scan_pack`), or the kernel's payload (`grouped`, `cyclic` or
        `fields`), its input form (`+fold` or `+unfold`), its output rows
        (`+foldo` folded out, `+foldo0` written by the kernel) and the
        folded pack's optional rows (`+fc`, `+fn`, `+fd`), e.g.
        `cuda/grouped+fold+foldo+fn`, the default."""
        if self.backend == "scan":
            return "scan/cyclic" + ("+packed" if self.scan_packed else "")
        fold = self.form["fold_inputs"] and self.packed
        name = ("fields" if not self.packed else "grouped" if self.grouped
                else "cyclic") + ("+fold" if fold else "+unfold") \
            + ("+foldo" if self.fold_outputs else "+foldo0")
        if fold:
            name += "".join(f"+{k}" for k in ("fc", "fn", "fd")
                            if self.form[k])
        return f"{route}/{name}"

    def prepare(self, inp):
        """InputData -> what one step consumes, on the host, before the cut
        into shares. The kernel: the pack of the driver's form (folded or
        unfolded) in its column layout: by default grouped in activity
        order (data.expand.activity_perm, dealt over the mesh's shares),
        grouped in source order, or cyclic (the identity layout when the
        snapshot is at least as wide as the run). The scan engine, and the
        kernel without packed storage: the plain field dict in cyclic
        order, zero-padded to a multiple of NPROMA columns (and of the
        mesh's size; the padding is cut from the outputs)."""
        if not self.packed:
            fields = make_inputs(inp, self.dtype)
            mult = math.lcm(self.nproma, self.ndevices)
            pad = -inp.ngptot % mult
            if pad:
                fields = {k: torch.nn.functional.pad(v, (0, pad))
                          for k, v in fields.items()}
            return fields
        klon = int(np.asarray(inp.fields["PT"]).shape[-1])
        self._group_perm = None
        if klon < inp.ngptot and self.group_sort:
            self._group_perm = activity_perm(
                inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"],
                inp.ptsphy, self.params.ydecldp.rlmin, nshards=self.ndevices,
            )
        return pack_inputs_raw(
            inp, self.params, self.scheme_config, self.dtype,
            self._group_perm,
            column_order="grouped" if self.grouped else "cyclic",
            **self.form)

    def shard(self, host) -> list:
        """The prepared host payload -> one payload a device, each its own
        contiguous column share (`dist.split_columns`) on its device: a
        contiguous `FoldedPack` (the kernel refuses a strided one), or a
        field dict. One device: the whole payload on it. Counts the bytes
        placed in `h2d_bytes`."""
        ncol = (host.ncol if isinstance(host, FoldedPack)
                else host["pt"].shape[-1])
        self.shares = dist.split_columns(ncol, self.ndevices)
        out = []
        for dev, (a, b) in zip(self.devices, self.shares):
            if isinstance(host, FoldedPack):
                if self.ndevices == 1:
                    out.append(host.to(dev))
                    continue
                out.append(dataclasses.replace(
                    host, pack=host.pack[..., a:b].to(dev).contiguous(),
                    col=host.col[..., a:b].to(dev).contiguous()))
            else:
                out.append({k: v[..., a:b].to(dev).contiguous()
                            for k, v in host.items()})
        tracing.count("h2d_bytes", sum(
            t.nbytes for x in out for t in ((x.pack, x.col) if isinstance(
                x, FoldedPack) else x.values())))
        return out

    def ungroup(self, outs: list, inp) -> list:
        """The layout's shards -> the canonical (cyclic) order's shares,
        `dist.split_columns(ngptot, ndevices)`, each on its device: in the
        grouped layouts canonical column j takes its source's first copy
        from whichever shard holds it. Copies of a snapshot column are
        bitwise-identical through the scheme, so this reconstructs the
        cyclic-layout outputs exactly. The cyclic layout is the canonical
        order already."""
        ncol = inp.ngptot
        klon = int(np.asarray(inp.fields["PT"]).shape[-1])
        if klon >= ncol or not self.grouped:
            if self.ndevices == 1:
                return outs
            inv = np.arange(ncol, dtype=np.int64)
        else:
            inv = group_inverse(klon, ncol,
                                perm=self._group_perm).astype(np.int64)
        starts = np.array([a for a, _ in self.shares])
        result = []
        for dev, (a, b) in zip(self.devices, dist.split_columns(
                ncol, self.ndevices)):
            idx = inv[a:b]
            owner = np.searchsorted(starts, idx, side="right") - 1
            fields = None
            for t in np.unique(owner):
                sel = np.nonzero(owner == t)[0]
                local = torch.from_numpy(idx[sel] - starts[t]).to(
                    outs[t].plude.device)
                got = [f[..., local].to(dev) for f in outs[t]]
                if len(sel) == b - a:  # one shard holds the whole share
                    fields = got
                    break
                if fields is None:
                    fields = [g.new_empty(g.shape[:-1] + (b - a,))
                              for g in got]
                sel = torch.from_numpy(sel).to(dev)
                for f, g in zip(fields, got):
                    f[..., sel] = g
            result.append(CloudscOutputs(*fields))
        return result

    def _sync(self):
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _prepack(self, payloads: list) -> list:
        """The scan engine's payloads stacked once on their devices
        (`scan_pack`, CLOUDSC_SCAN_PACKED=1), or as they are."""
        if not self.scan_packed:
            return payloads
        return [scan_pack(p, self.params, self.ptsphy, self.scheme_config)
                for p in payloads]

    def _call(self, payload):
        """One step on one device's payload: the scan engine, or the
        kernel's step on the pack or the field dict (`FusedStep`)."""
        if self.backend == "scan":
            return cloudsc(payload, self.params, self.ptsphy,
                           self.scheme_config)
        return self.step(payload)

    def _outputs(self, res, payload, ncol: int) -> CloudscOutputs:
        """One device's raw results -> CloudscOutputs in the payload's own
        column layout, the field dict's padding cut to `ncol` columns."""
        if self.backend != "scan":
            res = assemble(res, payload, self.step.c, self.fold_outputs)
        if not self.packed:
            return CloudscOutputs(*(a[..., :ncol] for a in res))
        return res

    def _debug_check(self, res, payloads, ncols, step):
        for r, p, n in zip(res, payloads, ncols):
            check_finite(self._outputs(r, p, n), step)

    def run(self, inp, iterations: int = 1, fetch_outputs: bool = True,
            trace=None, debug_nans: bool = False):
        """Run the scheme; returns (outputs in canonical column order,
        Timings, PerformanceTimer). With `fetch_outputs` the outputs come
        back as numpy arrays and the D2H copy is timed; without it they
        stay on the driver's device as tensors (validate them there with
        `validate.device_field_norms`). On a mesh of several devices the
        outputs without `fetch_outputs` are a list, one CloudscOutputs a
        device holding a canonical share of the columns, as
        `out_shares` lists them ([(device, (start, stop))]); fetched, they
        are whole.

        `trace` is a context manager entered around the timed loop only
        (a `torch.profiler.profile`). `debug_nans` checks every output of
        every call for a non-finite value (`check_finite`, step 0 the
        warm-up), each step then in its own timed window and the check
        outside it."""
        with tracing.span("cloudsc.prepare"):
            host = self.prepare(inp)
        timings = Timings()
        ncol = inp.ngptot

        with tracing.span("cloudsc.shard") as s:
            payloads = self.shard(host)
            del host
            self._sync()
        timings.h2d_s = s.seconds
        payloads = self._prepack(payloads)
        # real columns of each share (the scan engine's padding excluded)
        ncols = [max(0, min(b, ncol) - a) for a, b in self.shares]

        with tracing.span("cloudsc.warmup") as s:
            res = [self._call(p) for p in payloads]
            self._sync()
        timings.compile_s = s.seconds
        if debug_nans:
            self._debug_check(res, payloads, ncols, 0)

        n = self.ndevices
        timer = PerformanceTimer(ndevices=n)
        # energy sampling around the hot loop, gated by EC_PMON like the
        # reference (ref: ec_pmon_mod.F90:14-57, cloudsc_driver_mod.F90:
        # 170-178); the loop below ends synchronised on every device
        sampler = EnergySampler(self.device)
        sampler.start()
        timer.start()
        seconds = [0.0] * n
        windows = 1 if not debug_nans else iterations
        steps = iterations // windows
        with trace if trace is not None else contextlib.nullcontext(), \
                tracing.span("cloudsc.loop"):
            for w in range(windows):
                # drop the last step's outputs first, so the caching
                # allocator reuses their blocks: a cudaMalloc inside the
                # window stalls the host long enough to idle the card
                res = None
                if self.device.type == "cuda":
                    ev = []
                    for dev in self.devices:
                        with torch.cuda.device(dev):
                            ev.append((torch.cuda.Event(enable_timing=True),
                                       torch.cuda.Event(enable_timing=True)))
                            ev[-1][0].record()
                    for _ in range(steps):
                        res = None
                        res = [self._call(p) for p in payloads]
                    for dev, (_, stop) in zip(self.devices, ev):
                        with torch.cuda.device(dev):
                            stop.record()
                    for i, (start, stop) in enumerate(ev):
                        stop.synchronize()
                        seconds[i] += start.elapsed_time(stop) / 1e3
                else:
                    res = [None] * n
                    for _ in range(steps):
                        for i, p in enumerate(payloads):
                            t1 = time.perf_counter()
                            res[i] = self._call(p)
                            seconds[i] += time.perf_counter() - t1
                if debug_nans:
                    self._debug_check(res, payloads, ncols, w + 1)
        timer.end()
        timings.energy_line = sampler.stop_and_report()
        if self.device.type == "cuda":
            # the devices run side by side: the step is the slowest one's
            timings.compute_s = max(seconds) / iterations
        else:
            timings.compute_s = sum(seconds) / iterations
        for i in range(n):
            timer.log(i, seconds[i], ncols[i] * iterations)

        outs = [self._outputs(r, p, k)
                for r, p, k in zip(res, payloads, ncols)]
        del res, payloads
        with tracing.span("cloudsc.ungroup"):
            if not self.packed:
                keep = [i for i, k in enumerate(ncols) if k]
                self.out_shares = [
                    (self.devices[i], (self.shares[i][0],
                                       self.shares[i][0] + ncols[i]))
                    for i in keep]
                outs = [outs[i] for i in keep]
            else:
                outs = self.ungroup(outs, inp)
                self.out_shares = list(zip(self.devices, dist.split_columns(
                    ncol, n)))
        out = outs[0] if n == 1 else outs
        del outs
        if not fetch_outputs:
            return out, timings, timer
        self._sync()
        with tracing.span("cloudsc.fetch") as s:
            if n == 1:
                host_out = CloudscOutputs(*(a.cpu().numpy() for a in out))
            else:
                host_out = CloudscOutputs(*(
                    np.concatenate([f.cpu().numpy() for f in fs], axis=-1)
                    for fs in zip(*out)))
        timings.d2h_s = s.seconds
        return host_out, timings, timer
