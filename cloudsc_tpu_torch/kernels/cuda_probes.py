"""The measurement lab's synthetic probes: wrappers, plain versions, layout.

Counterparts of the two Pallas probes under `bench/`; their CUDA kernels
are `csrc/probes.cu`, built with the rest by `kernels/build.py`.

K2, the overlap probe (`bench/overlap_probe.py::make_fn`). A stream of
`(nk2, rr, ncol)` fp32 values, columns contiguous, with a chain of `w`
dependent multiply-adds on every value; variants `plain`, `alias` (a 3-row
k+1 lookahead on the same array), `scratch` (33 rows carried across
levels), `prod` (alias + scratch + a per-column output) and `branchy` (the
chain under the block's data-dependent predicate); modes `full` (streaming)
and `resident` (level 0 reread at every step). `overlap_step` launches the
kernel, `overlap_plain` is its plain version, and `probe_from_jax` /
`probe_to_jax` convert between the JAX probe's `(nk2, ni, rr, sb, 128)`
array and this layout: JAX element [k, i, r, s, l] is element
[k, r, (i*sb + s)*128 + l] here. The JAX probe defines, in resident mode,
only output block 0: level 0 and the column output of the first sb*128
columns are what the two share.

K3, the copy probe (`bench/dma_probe.py::make_copy`): `out = in *
1.0000001` over arrays copied in the access shape of the TPU's grid steps
(`CopyProbe`: contig<N>, strided, tilemajor). The kernel is a persistent
grid with a ring of TMA bulk copies a CTA (`COPY_RING`: stages, bytes a
stage, CTAs an SM); `CopyProbe.stage_copies` is its cut of the runs into
stages and `CopyProbe.stages` its deal of the stages to the CTAs, both
replayed on the CPU by the tests. `dma_copy` launches the kernel,
`dma_copy_plain` is its plain version, `copy_geometry` reads what the
built kernel runs with on the card.

Every multiply-add of K2 is one rounding, as XLA's contraction of the JAX
body and the kernel's fmaf compute it; the plain version takes it with
`fma32`. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises. `runtime.tracing` counts the
launches: `launches.overlap` and `launches.copy`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..runtime import tracing

LANES = 128
VARIANTS = ("plain", "alias", "scratch", "prod", "branchy")
OVERLAP_MODES = ("full", "resident")
# the w values the kernel is instantiated for (csrc/probes.cu OVERLAP_WS)
OVERLAP_W = (0, 1, 2, 3, 4, 8, 16, 32)
# the widest thread block, in 128-column units (csrc/probes.cu
# OVERLAP_MAX_THREADS = 256)
SB_MAX = 2
SCR_ROWS, LOOK_ROWS = 33, 3
COL_SHAPE = (8, 128)
# the probes' fp32 constants, as doubles
MUL = float(np.float32(1.0000001))
ADD = float(np.float32(1e-7))
SCR_IN, SCR_OUT, LOOK = (float(np.float32(v)) for v in (1e-8, 1e-9, 1e-9))


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """fp32 `a*b + c` with one rounding, a fused multiply-add. The product
    of two fp32 values is exact in fp64; the fp64 sum is made round-to-odd
    from its TwoSum error, and rounding that to fp32 equals rounding the
    exact `a*b + c` once (Boldo and Melquiond, IEEE TC 57(4), 2008)."""
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    p = a.double() * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _chain(v: torch.Tensor, w: int) -> torch.Tensor:
    for _ in range(w):
        v = fma32(v, MUL, ADD)
    return v


# ---------------------------------------------------------------------------
# K2: layout
# ---------------------------------------------------------------------------

def probe_from_jax(a, sb: int | None = None) -> torch.Tensor:
    """The JAX probe's `(nk2, ni, rr, sb, 128)` array (or its `(ni*sb, 128)`
    column output) -> this layout, `(nk2, rr, ncol)` (or `(ncol,)`)."""
    a = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
    if a.ndim == 2:
        return a.reshape(-1).contiguous()
    nk2, ni, rr, sb_, lanes = a.shape
    if lanes != LANES or (sb is not None and sb != sb_):
        raise ValueError(f"not a (nk2, ni, rr, {sb or 'sb'}, 128) probe "
                         f"array: {tuple(a.shape)}")
    return a.permute(0, 2, 1, 3, 4).reshape(nk2, rr, ni * sb_ * LANES) \
        .contiguous()


def probe_to_jax(x: torch.Tensor, sb: int) -> torch.Tensor:
    """This layout, `(nk2, rr, ncol)` (or `(ncol,)`) -> the JAX probe's
    `(nk2, ni, rr, sb, 128)` (or `(ni*sb, 128)`)."""
    if x.ndim == 1:
        return x.reshape(-1, LANES)
    nk2, rr, ncol = x.shape
    if ncol % (sb * LANES):
        raise ValueError(f"ncol {ncol} is not a multiple of sb*128")
    return x.reshape(nk2, rr, ncol // (sb * LANES), sb, LANES) \
        .permute(0, 2, 1, 3, 4).contiguous()


# ---------------------------------------------------------------------------
# K2: the step
# ---------------------------------------------------------------------------

def check_overlap_args(x, col, variant, mode, w, sb, cuda: bool) -> None:
    """Raise ValueError for what the probe does not take (and, with `cuda`,
    for what its kernel does not: a w outside OVERLAP_W, a tensor off the
    card)."""
    if variant not in VARIANTS or mode not in OVERLAP_MODES:
        raise ValueError(f"variant {variant!r} / mode {mode!r}: one of "
                         f"{VARIANTS} / {OVERLAP_MODES}")
    if not 1 <= sb <= SB_MAX:
        raise ValueError(f"sb {sb}: 1 to {SB_MAX} (the thread block is "
                         f"sb*128 columns)")
    if x.dtype != torch.float32 or col.dtype != torch.float32:
        raise ValueError("the overlap probe is fp32")
    if x.ndim != 3 or x.shape[2] % (sb * LANES) or tuple(col.shape) != \
            COL_SHAPE:
        raise ValueError(f"x {tuple(x.shape)} must be (nk2, rr, ncol) with "
                         f"ncol a multiple of sb*128, col (8, 128)")
    head = {"alias": LOOK_ROWS, "scratch": SCR_ROWS, "prod": SCR_ROWS}
    if x.shape[1] < head.get(variant, 1):
        raise ValueError(f"{variant} needs rr >= {head[variant]}")
    if not cuda:
        return
    if w not in OVERLAP_W:
        raise ValueError(f"w {w}: the kernel is built for {OVERLAP_W}")
    if not (x.is_contiguous() and col.is_contiguous()):
        raise ValueError("x and col must be contiguous")
    if x.device.type != "cuda" or col.device != x.device:
        raise ValueError("the kernel needs x and col on one CUDA device")


def overlap_step(x: torch.Tensor, col: torch.Tensor, variant: str,
                 mode: str = "full", w: int = 0, sb: int = 1):
    """One pass of the overlap probe -> (out, colo, col_out): out
    `(nk2, rr, ncol)` (resident: `(1, rr, ncol)`, level 0), colo `(ncol,)`
    for `prod` (else None), col_out `(8, 128)`. A CUDA x launches the
    kernel (or raises); a CPU x runs the plain version."""
    if x.device.type == "cpu":
        return overlap_plain(x, col, variant, mode, w, sb)
    check_overlap_args(x, col, variant, mode, w, sb, cuda=True)
    from . import build

    lib = build.load_library()
    nk2, rr, ncol = x.shape
    resident = mode == "resident"
    out = x.new_empty((1 if resident else nk2, rr, ncol))
    colo = x.new_empty((ncol,)) if variant == "prod" else None
    col_out = torch.empty_like(col)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.overlap_probe(
            x.data_ptr(), col.data_ptr(), out.data_ptr(),
            colo.data_ptr() if colo is not None else None, col_out.data_ptr(),
            VARIANTS.index(variant), w, int(resident), nk2, rr, ncol, sb,
            stream)
    tracing.count("launches.overlap")
    if rc != 0:
        raise RuntimeError(f"overlap_probe launch failed: CUDA error {rc}")
    return out, colo, col_out


def overlap_plain(x: torch.Tensor, col: torch.Tensor, variant: str,
                  mode: str = "full", w: int = 0, sb: int = 1):
    """Plain version of the overlap probe on this layout, vectorised over
    columns (a loop over levels only), on x's device. Same outputs as
    `overlap_step`."""
    check_overlap_args(x, col, variant, mode, w, sb, cuda=False)
    nk2, rr, ncol = x.shape
    alias = variant in ("alias", "prod")
    scratch = variant in ("scratch", "prod")
    resident = mode == "resident"
    out = x.new_empty((1 if resident else nk2, rr, ncol))
    acc = x.new_zeros((SCR_ROWS, ncol))
    for k in range(nk2):
        v = x[0 if resident else k]
        y = _chain(v, w)
        if variant == "branchy":
            # the predicate of each thread block: its row-0 max at level k
            pred = v[0].reshape(-1, sb * LANES).amax(1) > 0.5
            y = torch.where(pred.repeat_interleave(sb * LANES), y, v)
        if scratch:
            acc = fma32(y[:SCR_ROWS], SCR_IN, acc)
            y = torch.cat([fma32(acc, SCR_OUT, y[:SCR_ROWS]), y[SCR_ROWS:]])
        if alias:
            look = x[0 if resident else min(k + 1, nk2 - 1), :LOOK_ROWS]
            y = torch.cat([fma32(look, LOOK, y[:LOOK_ROWS]), y[LOOK_ROWS:]])
        out[0 if resident else k] = y
    colo = out[-1, 0] * MUL if variant == "prod" else None
    return out, colo, col * MUL


# ---------------------------------------------------------------------------
# K3: the copy probe's geometry and step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CopyRing:
    """K3's ring: `stages` (S) slots of at most `chunk` bytes a CTA in
    shared memory, and `ctas` CTAs an SM in the persistent grid."""

    stages: int
    chunk: int
    ctas: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA."""
        return self.stages * self.chunk

    def macros(self) -> tuple:
        """The COPY_RING_* flags of csrc/probes.cu."""
        return (f"-DCOPY_RING_STAGES={self.stages}",
                f"-DCOPY_RING_CHUNK={self.chunk}",
                f"-DCOPY_RING_CTAS={self.ctas}")


# the copy ring K3 is built with, the best worst case over the lab's probes
# (sb 32 and 1) of fifteen rings swept with `bench/dma_probe.py` on an H100
# (PERF.md); kernels/build.py passes it to csrc/probes.cu as the
# COPY_RING_* macros when it makes the flags
COPY_RING = CopyRing(stages=6, chunk=16384, ctas=2)
# the kernel's threads a CTA (csrc/probes.cu COPY_THREADS)
COPY_THREADS = 256


@dataclasses.dataclass(frozen=True)
class CopyProbe:
    """One copy probe: the array `shape`, the TPU's `block` and `grid` (for
    the record), and what each of its `ni * nk2` TPU grid steps copies:
    step (i, k) = (b % ni, b // ni) copies `nruns` runs of `run_len`
    floats, run q at `i*base_i + k*base_k + q*run_stride`."""

    name: str
    shape: tuple
    block: tuple
    grid: tuple
    run_len: int
    nruns: int
    run_stride: int
    ni: int
    nk2: int
    base_i: int
    base_k: int

    @property
    def nsteps(self) -> int:
        return self.ni * self.nk2

    def offsets(self, i: int, k: int) -> np.ndarray:
        """The flat offsets TPU grid step (i, k) reads and writes, run by
        run."""
        base = i * self.base_i + k * self.base_k
        runs = base + self.run_stride * np.arange(self.nruns)
        return (runs[:, None] + np.arange(self.run_len)[None]).reshape(-1)

    def stage_plan(self, chunk: int) -> tuple[int, int]:
        """(stages a step, pieces a run) for stages of at most `chunk`
        bytes. A run longer than `chunk` is cut into ceil(run / chunk)
        pieces of whole 16-byte units, as equal as they come, the longer
        first; shorter runs are gathered whole (1 piece a run), as many
        consecutive runs of a step as fit, spread as evenly over the step's
        stages, the fuller first."""
        run_bytes = 4 * self.run_len
        if run_bytes > chunk:
            ppr = -(-run_bytes // chunk)
            return self.nruns * ppr, ppr
        return -(-self.nruns // (chunk // run_bytes)), 1

    def nstages(self, chunk: int) -> int:
        return self.nsteps * self.stage_plan(chunk)[0]

    def stage_copies(self, chunk: int, t) -> tuple:
        """The bulk copies of stages `t` (an array of stage numbers), in
        the kernel's order -> (stage, offset, nbytes) arrays, one entry a
        copy, offsets and sizes in bytes of the flat array. The kernel's
        `StageWalk` computes the same integers."""
        sps, ppr = self.stage_plan(chunk)
        run_bytes = 4 * self.run_len
        t = np.asarray(t, dtype=np.int64)
        b, r = np.divmod(t, sps)
        base = (b % self.ni) * self.base_i + (b // self.ni) * self.base_k
        if ppr > 1:
            q, p = np.divmod(r, ppr)
            per, rem = divmod(run_bytes // 16, ppr)
            g = base + q * self.run_stride + 4 * (p * per + np.minimum(p, rem))
            nq = np.ones_like(t)
            size = 16 * (per + (p < rem))
        else:
            per, rem = divmod(self.nruns, sps)
            g = base + (r * per + np.minimum(r, rem)) * self.run_stride
            nq = per + (r < rem)
            size = np.full_like(t, run_bytes)
        first = np.repeat(np.cumsum(nq) - nq, nq)
        m = np.arange(int(nq.sum()), dtype=np.int64) - first
        return (np.repeat(t, nq),
                4 * (np.repeat(g, nq) + m * self.run_stride),
                np.repeat(size, nq))

    def stages(self, nctas: int, chunk: int) -> list:
        """Each CTA's stages, in its order: CTA c runs stages c, c + nctas,
        ... ; a stage is its list of (offset, nbytes) bulk copies."""
        total = self.nstages(chunk)
        out = []
        for c in range(nctas):
            stage, off, size = self.stage_copies(
                chunk, np.arange(c, total, nctas))
            mine = {}
            for t, o, n in zip(stage.tolist(), off.tolist(), size.tolist()):
                mine.setdefault(t, []).append((o, n))
            out.append(list(mine.values()))
        return out


def contig_probe(cs: int, nsteps: int) -> CopyProbe:
    """contig<cs>: array (nsteps, cs, 128); step i copies block (i, 0, 0),
    one contiguous run of cs*128 floats."""
    run = cs * LANES
    return CopyProbe(f"contig{cs}", (nsteps, cs, LANES), (1, cs, LANES),
                     (nsteps,), run, 1, run, nsteps, 1, run, 0)


def strided_probe(nk2: int, lps: int, rows: int, nblk: int,
                  sb: int) -> CopyProbe:
    """strided: array (nk2*lps, rows, nblk, 128); step (i, k) copies block
    (k, 0, i, 0) of shape (lps, rows, sb, 128): lps*rows runs of sb*128
    floats, one row apart."""
    if nblk % sb:
        raise ValueError(f"nblk {nblk} is not a multiple of sb {sb}")
    ni, row = nblk // sb, nblk * LANES
    return CopyProbe("strided", (nk2 * lps, rows, nblk, LANES),
                     (lps, rows, sb, LANES), (ni, nk2), sb * LANES,
                     lps * rows, row, ni, nk2, sb * LANES, lps * rows * row)


def tilemajor_probe(nk2: int, ni: int, lps: int, rows: int,
                    sb: int) -> CopyProbe:
    """tilemajor: array (nk2, ni, lps*rows, sb, 128); step (i, k) copies
    block (k, i, 0, 0, 0), one run of lps*rows*sb*128 floats."""
    run = lps * rows * sb * LANES
    return CopyProbe("tilemajor", (nk2, ni, lps * rows, sb, LANES),
                     (1, 1, lps * rows, sb, LANES), (ni, nk2), run, 1, run,
                     ni, nk2, run, ni * run)


def check_copy_args(x, col, probe: CopyProbe) -> None:
    """Raise ValueError for what the kernel does not take: a shape other
    than the probe's, a type other than fp32, tensors that are not
    contiguous, not on one CUDA device or not 16-byte aligned (bulk copies
    move whole 16-byte units between aligned addresses; a view with a
    storage offset may not be), or runs and offsets that are not whole
    16-byte units."""
    if tuple(x.shape) != probe.shape or tuple(col.shape) != COL_SHAPE:
        raise ValueError(f"x {tuple(x.shape)} / col {tuple(col.shape)}: the "
                         f"probe takes {probe.shape} / {COL_SHAPE}")
    if x.dtype != torch.float32 or col.dtype != torch.float32:
        raise ValueError("the copy probe is fp32")
    if not (x.is_contiguous() and col.is_contiguous()):
        raise ValueError("x and col must be contiguous")
    if x.device.type != "cuda" or col.device != x.device:
        raise ValueError("the kernel needs x and col on one CUDA device")
    if x.data_ptr() % 16 or col.data_ptr() % 16:
        raise ValueError("x and col must be 16-byte aligned (bulk copies)")
    if any(v % 4 for v in (probe.run_len, probe.run_stride, probe.base_i,
                           probe.base_k)):
        raise ValueError("the probe's runs and offsets must be whole "
                         "16-byte units")


def dma_copy(x: torch.Tensor, col: torch.Tensor, probe: CopyProbe):
    """One pass of the copy probe -> (x * 1.0000001, col * 1.0000001). A
    CUDA x launches the kernel with the probe's access shape (or raises); a
    CPU x runs the plain version."""
    if x.device.type == "cpu":
        return dma_copy_plain(x, col)
    check_copy_args(x, col, probe)
    from . import build

    lib = build.load_library()
    out = torch.empty_like(x)  # the allocator's blocks are 512-byte aligned
    col_out = torch.empty_like(col)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.copy_probe(
            x.data_ptr(), col.data_ptr(), out.data_ptr(), col_out.data_ptr(),
            probe.run_len, probe.nruns, probe.run_stride, probe.ni,
            probe.base_i, probe.base_k, probe.nsteps, stream)
    tracing.count("launches.copy")
    if rc != 0:
        raise RuntimeError(f"copy_probe launch failed: CUDA error {rc}")
    return out, col_out


COPY_GEOMETRY_KEYS = ("blocks_per_sm", "smem_bytes", "stages", "chunk",
                      "ctas", "sms", "threads", "registers", "local_bytes")


def copy_geometry() -> dict:
    """What K3 runs with on the current CUDA device, from the built
    library: the CTAs an SM that fit, the dynamic shared memory a CTA, its
    ring (S, bytes a stage, CTAs an SM), the SMs, the threads a CTA, and
    the registers and local-memory bytes a thread. Needs a card."""
    import ctypes

    from . import build

    lib = build.load_library()
    out = (ctypes.c_int * len(COPY_GEOMETRY_KEYS))()
    rc = lib.copy_probe_geometry(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"copy_probe_geometry failed: CUDA error {rc}")
    return dict(zip(COPY_GEOMETRY_KEYS, out))


def dma_copy_plain(x: torch.Tensor, col: torch.Tensor):
    """Plain version of the copy probe, on x's device."""
    return x * 1.0000001, col * 1.0000001
