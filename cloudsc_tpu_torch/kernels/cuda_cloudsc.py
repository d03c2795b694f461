"""The fused CLOUDSC step: folded input pack, CUDA kernel, plain version, outputs.

Counterpart of `cloudsc_tpu/kernels/pallas_cloudsc.py`: the folded layout
with the folded-out flux rows, in every form the TPU kernel takes (the
optional streamed saturation-curve, ZDQS and deposition rows; the main path
streams ZDQS alone), on grouped or cyclic columns.
The TPU kernel it replaces is `_build` -> `pl.pallas_call(_kernel)` there; its
Hopper translation is `csrc/cloudsc_fused.cu` (with `csrc/cloudsc_scheme.cuh`),
built by `kernels/build.py`.

Layout. The host pack is `(nlev+1, nrows, ncol)` with columns contiguous:
element (k, r, j) at `(k*nrows + r)*ncol + j`, so one thread per column reads
and writes coalesced. Per-level rows carry an edge-replicated row `nlev`;
`paph` has its real surface value there. Nothing of the TPU layout carries
over (no (8, 128) tiles, no padding: the kernel bounds-checks its column).
The pack states its own layout — its row names, and which optional rows it
streams (`fc`, `fn`, `fd`) — so no consumer infers it from a row count.

`cloudsc_fused` launches the kernel for a CUDA pack (or raises) and runs
`cloudsc_fused_plain` — a level loop over `physics.scheme` on `(ncol,)` rows
that mirrors the Pallas `_kernel` / `_sub_level` / `_write_level_rows` — for a
CPU pack. Its `mode` also selects the TPU kernel's two diagnostic bodies
(`floor`, `init`: the same I/O with degenerate or section-1 compute, for the
measurement lab), with plain versions `cloudsc_floor_plain` /
`cloudsc_init_plain`. `LAUNCHES`, `FLOOR_LAUNCHES` and `INIT_LAUNCHES` count
the launches of the three bodies, `VERSION_LAUNCHES` the full body's by
scheme version.

The kernel streams each column's input rows through a per-thread ring of
shared-memory stages filled by asynchronous copies. `RING` holds its
geometry, the same in both precisions (the build passes it to the source
as macros),
`ring_schedule` models its slots and copy groups, and `occupancy` reads
what the built kernel runs with on the card. Each version of the kernel
(`KernelVersion`: SchemeConfig's switches, skips and the aerosol couplings,
and the pack's form) is a build of its own, made at first use;
`kernel_version(c, p.form)` names the one a configuration and pack run.
"""

from __future__ import annotations

import collections
import dataclasses
import os

import numpy as np
import torch

from ..physics import satfold, scheme
from ..physics.cloudsc import CloudscOutputs
from ..physics.scheme import IL, II, IR, IS, NCLV

# kernel launches since import (or since a caller reset them), per body;
# VERSION_LAUNCHES splits the full body's by scheme version (KernelVersion)
LAUNCHES = 0
FLOOR_LAUNCHES = 0
INIT_LAUNCHES = 0
VERSION_LAUNCHES: collections.Counter = collections.Counter()
# mode -> the body's name in the C entry points (cloudsc_<body>_<f32|f64>)
_BODIES = {"full": "fused", "floor": "floor", "init": "init"}
MODES = tuple(_BODIES)

# folded per-level rows (pallas_cloudsc._PACK_ROWS_F), then the streamed ZDQS
# row of the fn contract; rows 0-2 are the ones also read at level k+1
PACK_ROWS = (
    "pmf", "plu", "paph",
    "ztp1_in", "zqv_in", "za_in", "pap", "pvervel", "zhr",
    "plude", "psnde", "psupsat", "pvfl", "pvfi",
    "zqx0_in", "zqx1_in", "zqx2_in", "zqx3_in",
)
ZDQS_ROW = "zdqs"
# the optional rows of the other forms (pallas_cloudsc._CURVE_PACK_ROWS,
# _DEP_PACK_ROWS): section 1's saturation block and 3.7's deposition chain
CURVE_ROWS = satfold.CURVE_ROWS
DEP_ROWS = satfold.DEP_ROWS
# the forms' environment switches and defaults (pallas_cloudsc.py:258-278)
FOLD_ENV = (("fc", "CLOUDSC_FOLD_CURVES", "0"),
            ("fn", "CLOUDSC_FOLD_NEWTON", "1"),
            ("fd", "CLOUDSC_FOLD_DEP", "0"))
# per-column rows of `col`
COL_ROWS = ("plsm", "ldcum", "ktype", "paph_surf")
# rows of the per-level output buffer (the vapour-slot cloud tendency is
# identically zero and synthesized in `assemble`)
OLEV_ROWS = ("plude", "pcovptot", "tend_t", "tend_q", "tend_a",
             "tcld0", "tcld1", "tcld2", "tcld3")
# rows of the half-level flux buffer; PFSQLTUR/PFSQITUR and PFHPSL/PFHPSN
# are pure functions of streamed values and are rebuilt in `assemble`
OHALF_ROWS = ("pfsqlf", "pfsqif", "pfcqlng", "pfcqnng", "pfsqrf", "pfsqsf",
              "pfcqrng", "pfcqsng", "pfplsl", "pfplsn")

_C_NAMES = (
    "ptsphy", "zqtmst", "RG", "RD", "RV", "RTT", "RETV", "RLSTT",
    "R4LES", "R4IES", "R5LES", "R5IES", "RALVDCP", "RALSDCP",
    "zrldcp", "zrg_r", "zepsilon", "NSSOPT", "NCLDTOP",
)
_THF_NAMES = (
    "r2es", "r3les", "r3ies", "rtice", "rtwat", "rtwat_rtice_r",
    "rkoop1", "rkoop2", "r5alvcp", "r5alscp",
)
_E_NAMES = (
    "rlmin", "ramin", "rthomo", "rkooptau", "ramid", "rcldtopcf",
    "rvice", "rvrain", "rvsnow", "riceinit",
    "rdepliqrefrate", "rdepliqrefdepth", "rcovpmin", "rdensref",
    "rsnowlin2", "rlcritsnow", "rclcrit_land", "rclcrit_sea",
    "rcl_kkaau", "rcl_kkbauq", "rcl_kkaac", "rcl_kkbac",
    "rcl_const1s", "rcl_const7s", "rcl_const8s", "rtaumel",
    "rcl_fac1", "rcl_fzrab", "rcl_const5r", "rprecrhmax",
    "rcl_cdenom1", "rcl_cdenom2", "rcl_cdenom3", "rcl_const1r",
    "rcl_const2r", "rvrfactor",
)
# Scalar-only subexpressions of the JAX scheme, which Python evaluates in
# double before they meet a tensor: folded here in the same order, so the
# kernel never recomputes them in another rounding.
_FOLDED = {
    "rdtgdp_fac": lambda c, e: 1.0 / (c.ptsphy * c.RG),
    "zfaci_cold": lambda c, e: c.ptsphy / e.rkooptau,
    "one_m_ramin": lambda c, e: 1.0 - e.ramin,
    "ldifdt_conv": lambda c, e: e.rcldiff_convi * e.rcldiff * c.ptsphy,
    "ldifdt": lambda c, e: e.rcldiff * c.ptsphy,
    "zrdcp_half": lambda c, e: c.zrdcp * 0.5,
    "one_m_ramid": lambda c, e: 1.0 - e.ramid,
    "snowlin_fac": lambda c, e: c.ptsphy * e.rsnowlin1,
    "kk_pow_land": lambda c, e: e.rcl_kk_cloud_num_land ** e.rcl_kkbaun,
    "kk_pow_sea": lambda c, e: e.rcl_kk_cloud_num_sea ** e.rcl_kkbaun,
    "fac2_c6r": lambda c, e: e.rcl_fac2 * e.rcl_const6r,
    "fac2_c4r": lambda c, e: e.rcl_fac2 * e.rcl_const4r,
    "fac2_c3r": lambda c, e: e.rcl_fac2 * e.rcl_const3r,
    "one_m_rprecrhmax": lambda c, e: 1.0 - e.rprecrhmax,
    "rv_over_rd": lambda c, e: c.RV / c.RD,
    "rg_rpecons": lambda c, e: c.RG * e.rpecons,
}
# what only the scheme's alternate branches and aerosol couplings read,
# appended so the reference configuration's constants keep their places
_ALT_NAMES = (
    "rprc1", "rccn", "rnice", "rcl_apb1", "rcl_apb2", "rcl_apb3",
    "rcl_const1i", "rcl_const2i", "rcl_const3i", "rcl_const4i",
    "rcl_const5i", "rcl_const2s", "rcl_const3s", "rcl_const4s",
    "rcl_const5s",
)
_ALT_FOLDED = {
    "rkconv_dt": lambda c, e: e.rkconv * c.ptsphy,
    "rg_rpecons_half": lambda c, e: c.RG * e.rpecons * 0.5,
    "c065_const6i": lambda c, e: 0.65 * e.rcl_const6i,
    "c065_const6s": lambda c, e: 0.65 * e.rcl_const6s,
}
# The flat constants vector the kernel reads, one double each, in this
# order; csrc/cloudsc_scheme.cuh declares the matching `enum Const`.
CONST_NAMES = _C_NAMES + _THF_NAMES + _E_NAMES + tuple(_FOLDED) \
    + _ALT_NAMES + tuple(_ALT_FOLDED)


@dataclasses.dataclass(frozen=True)
class RingGeometry:
    """K1's input ring: `stages` (S) levels of the pack's rows a block in
    shared memory, `block` threads a block, and the `__launch_bounds__`
    minimum of `min_blocks` blocks an SM (a register cap, not a promise)."""

    stages: int
    block: int
    min_blocks: int

    def smem_bytes(self, itemsize: int, nrows: int | None = None) -> int:
        """Dynamic shared memory of one block: [S][rows][block] values, for
        a pack of `nrows` rows (the reference configuration's 19 if None)."""
        nrows = len(pack_rows()) if nrows is None else nrows
        return self.stages * nrows * self.block * itemsize


# the ring geometry K1 is built with in both precisions, the fastest in
# each of the trials of bench/ring_sweep.py on an H100 (PERF.md);
# kernels/build.py passes it to csrc/cloudsc_fused.cu as the
# CLOUDSC_RING_* macros
RING = RingGeometry(stages=4, block=128, min_blocks=2)


@dataclasses.dataclass(frozen=True)
class KernelVersion:
    """What one build of K1 computes: SchemeConfig's four switches and the
    aerosol couplings, the pack's form (`fc`, `fn`, `fd`: its optional
    rows), the skipped sections (`skip`, a frozenset of scheme.SKIP_TAGS),
    `dynamic_skips` and `s521_round_skip`. kernels/build.py passes it to
    csrc/cloudsc_scheme.cuh as the CLOUDSC_* macros (one a skip tag), one
    library a version. The liquid couplings act only under IWARMRAIN=1, so
    `kernel_version` drops them elsewhere and such a configuration shares
    its build with the uncoupled one."""

    iwarmrain: int = 2
    ievaprain: int = 2
    ievapsnow: int = 1
    idepice: int = 1
    laericesed: bool = False
    laericeauto: bool = False
    laerliqautolsp: bool = False
    laerliqcoll: bool = False
    fc: bool = False
    fn: bool = True
    fd: bool = False
    skip: frozenset = frozenset()
    dynamic_skips: bool = True
    s521_round_skip: bool = False

    def macros(self) -> tuple:
        out = []
        for f in dataclasses.fields(self):
            if f.name == "skip":
                out += [f"-DCLOUDSC_SKIP_{t.upper()}={int(t in self.skip)}"
                        for t in scheme.SKIP_TAGS]
            else:
                out.append(f"-DCLOUDSC_{f.name.upper()}="
                           f"{int(getattr(self, f.name))}")
        return tuple(out)


# the reference configuration (2, 2, 1, 1), no aerosol coupling, the main
# path's form (the streamed ZDQS row alone), no skip
DEFAULT_VERSION = KernelVersion()


def kernel_version(c, form=None) -> KernelVersion:
    """The build that computes `derived_consts` `c`'s configuration on a
    pack of `form` ({"fc", "fn", "fd"} -> bool, `FoldedPack.form`; the
    main path's, the streamed ZDQS row alone, if None)."""
    liq = c.IWARMRAIN == 1
    return KernelVersion(
        c.IWARMRAIN, c.IEVAPRAIN, c.IEVAPSNOW, c.IDEPICE, c.LAERICESED,
        c.LAERICEAUTO, liq and c.LAERLIQAUTOLSP, liq and c.LAERLIQCOLL,
        skip=frozenset(c.skip), dynamic_skips=bool(c.dynamic_skips),
        s521_round_skip=bool(c.s521_round_skip), **(form or {}))


def fold_flags() -> dict:
    """{"fc", "fn", "fd"} -> bool from CLOUDSC_FOLD_CURVES / _NEWTON / _DEP
    (defaults 0 / 1 / 0, as the JAX package's readers)."""
    return {k: os.environ.get(var, default) == "1"
            for k, var, default in FOLD_ENV}


def ring_schedule(nlev: int, stages: int) -> list[tuple]:
    """The order in which one thread of K1 copies, commits, waits for and
    reads its ring, for `nlev` levels (pack levels 0..nlev) and S =
    `stages`: ("copy", level, stage), ("commit",), ("wait", n) — every
    committed group but the n most recent is complete — and ("read",
    level, stage). Level L goes to stage L % S; group g holds level g (or
    nothing, past nlev). The prologue copies levels 0..S-2; level k, before
    it computes, copies level k+S-1, waits with n = S-2 and reads levels k
    and k+1 (the k+1 rows pmf, plu, paph)."""
    d = stages - 1
    ops: list[tuple] = []

    def fetch(lev):
        if lev <= nlev:
            ops.append(("copy", lev, lev % stages))
        ops.append(("commit",))

    for lev in range(d):
        fetch(lev)
    for k in range(nlev):
        fetch(k + d)
        ops.append(("wait", stages - 2))
        ops.append(("read", k, k % stages))
        ops.append(("read", k + 1, (k + 1) % stages))
    ops.append(("wait", 0))
    return ops


def const_values(c) -> dict:
    """CONST_NAMES -> value, from the port's `derived_consts`."""
    v = {n: getattr(c, n) for n in _C_NAMES}
    v.update({n: getattr(c.thf, n) for n in _THF_NAMES})
    v.update({n: getattr(c.e, n) for n in _E_NAMES + _ALT_NAMES})
    v.update({n: f(c, c.e) for n, f in {**_FOLDED, **_ALT_FOLDED}.items()})
    return v


def const_vector(c, device=None) -> torch.Tensor:
    """The kernel's constants as one float64 tensor in CONST_NAMES order."""
    v = const_values(c)
    return torch.tensor([float(v[n]) for n in CONST_NAMES],
                        dtype=torch.float64, device=device)


def aer_rows(c) -> list[str]:
    """Extra per-level fields the enabled aerosol couplings read
    (pallas_cloudsc._aer_rows)."""
    rows = []
    if c.LAERICESED:
        rows.append("pre_ice")
    if c.LAERICEAUTO:
        rows += ["picrit_aer", "pnice"]
    if (c.LAERLIQAUTOLSP or c.LAERLIQCOLL) and c.IWARMRAIN == 1:
        rows += ["plcrit_aer", "pccn"]
    return rows


@dataclasses.dataclass
class FoldedPack:
    """The folded input pack with its own layout: `pack (nlev+1, nrows,
    ncol)`, `col (4, ncol)`, the row names and its form: whether it streams
    the saturation-curve rows (`fc`), the ZDQS row (`fn`) and the
    deposition rows (`fd`)."""

    pack: torch.Tensor
    col: torch.Tensor
    rows: tuple
    fn: bool
    fc: bool = False
    fd: bool = False

    @property
    def form(self) -> dict:
        return {"fc": self.fc, "fn": self.fn, "fd": self.fd}

    @property
    def nlev(self) -> int:
        return self.pack.shape[0] - 1

    @property
    def ncol(self) -> int:
        return self.pack.shape[2]

    def row(self, name: str) -> int:
        return self.rows.index(name)

    def to(self, device) -> "FoldedPack":
        return dataclasses.replace(self, pack=self.pack.to(device),
                                   col=self.col.to(device))


def pack_rows(fc: bool = False, fn: bool = True, fd: bool = False,
              aer=()) -> tuple:
    """The pack's rows in pallas_cloudsc._pack_rows_f's order: PACK_ROWS,
    the curve rows (fc), ZDQS (fn), the deposition rows (fd), then `aer`."""
    return PACK_ROWS + (CURVE_ROWS if fc else ()) \
        + ((ZDQS_ROW,) if fn else ()) + (DEP_ROWS if fd else ()) + tuple(aer)


def folded_rows(get, ptsphy, c=None, fc: bool = False, fn: bool = False,
                fd: bool = False) -> dict:
    """The folded per-level rows (name -> array) from a raw-field accessor
    `get(NAME[, species])` returning fp64 file-width arrays — the fold is
    computed in fp64 and rounded once by the later working-precision cast
    (pallas_cloudsc._folded_rows; ref: cloudsc.F90:662-682, 1145,
    1288-1289). With `c`, `fc` adds the saturation-curve rows, `fn` the
    ZDQS row and `fd` the deposition rows of `c`'s IDEPICE
    (physics/satfold)."""
    rows = {
        "pmf": get("PMFU") + get("PMFD"),
        "plu": get("PLU"),
        "paph": get("PAPH"),
        "ztp1_in": get("PT") + ptsphy * get("TENDENCY_TMP_T"),
        "zqv_in": get("PQ") + ptsphy * get("TENDENCY_TMP_Q"),
        "za_in": get("PA") + ptsphy * get("TENDENCY_TMP_A"),
        "pap": get("PAP"),
        "pvervel": get("PVERVEL"),
        "zhr": get("PHRSW") + get("PHRLW"),
        "plude": get("PLUDE"),
        "psnde": get("PSNDE"),
        "psupsat": get("PSUPSAT"),
        "pvfl": get("PVFL"),
        "pvfi": get("PVFI"),
        **{
            f"zqx{m}_in": get("PCLV", m) + ptsphy * get("TENDENCY_TMP_CLD", m)
            for m in range(4)
        },
    }
    if fc or fn or fd:
        curves = satfold.curve_rows(c, rows["ztp1_in"], rows["pap"])
        if fc:
            rows.update(curves)
        if fn:
            rows["zdqs"] = satfold.newton_zdqs(
                c, rows["ztp1_in"], rows["pap"], rows["paph"], rows["pmf"],
                rows["zhr"], rows["pvervel"], curves["zqsmix"],
            )
        if fd:
            rows.update(satfold.dep_rows(
                c, rows["ztp1_in"], rows["zqv_in"], rows["za_in"],
                [rows[f"zqx{m}_in"] for m in range(4)], rows["pap"], curves))
    return rows


def pack_expand(rows, ncol, nlev_rows, dtype,
                grouped: bool = True) -> torch.Tensor:
    """Expansion of file-width fp64 rows to `ncol` columns -> one
    `(nlev_rows, len(rows), ncol)` host tensor, the level index clamped to
    each row's own height, cast once to `dtype`
    (pallas_cloudsc._pack_expand_numpy). The cast happens at file width,
    which rounds the same values the expanded cast would. Grouped: each
    source column's copies contiguous; the layout holds `ncol // klon + 1`
    copies of each of the first `ncol % klon` sources and `ncol // klon` of
    the rest, so the expansion is two broadcast copies. Cyclic: column j
    holds source `j % klon`, a gather."""
    rows = [np.atleast_2d(np.asarray(r, np.float64)) for r in rows]
    klon = rows[0].shape[-1]
    small = np.empty((nlev_rows, len(rows), klon), np.float64)
    for r, a in enumerate(rows):
        small[:, r] = a[np.minimum(np.arange(nlev_rows), a.shape[0] - 1)]
    src = torch.from_numpy(small).to(dtype)
    if not grouped:
        return src[..., torch.arange(ncol) % klon].contiguous()
    dst = torch.empty((nlev_rows, len(rows), ncol), dtype=dtype)
    reps, g1 = divmod(ncol, klon)
    head = g1 * (reps + 1)
    for cols, srcs, n in ((slice(0, head), slice(0, g1), reps + 1),
                          (slice(head, ncol), slice(g1, klon), reps)):
        if n:
            dst[..., cols].unflatten(-1, (-1, n)).copy_(
                src[..., srcs, None].expand(-1, -1, -1, n))
    return dst


def pack_inputs_folded(inp, params, config=None, dtype=torch.float32,
                       perm=None, fn: bool = True,
                       column_order: str = "grouped", fc: bool = False,
                       fd: bool = False) -> FoldedPack:
    """Folded pack on the host from an unexpanded `InputData`: fold in fp64
    at file width, expand to `inp.ngptot` columns in grouped order (source
    columns permuted by `perm` first, `data.expand.activity_perm`) or, with
    `column_order="cyclic"`, in the cyclic order of `data.expand`; cast
    once. The form: `fn` streams the ZDQS row (the main path; without it the
    kernel runs the in-line CUADJTQ), `fc` the saturation-curve rows, `fd`
    the deposition rows. Returns host tensors."""
    if column_order not in ("grouped", "cyclic"):
        raise ValueError(f"column_order {column_order!r}: grouped or cyclic")
    grouped = column_order == "grouped"
    if perm is not None and not grouped:
        raise ValueError("perm requires column_order='grouped'")
    f = inp.fields
    ncol, nlev = inp.ngptot, inp.klev
    c = scheme.derived_consts(params, float(inp.ptsphy), dtype, config)
    aer = aer_rows(c)

    def _p(a):
        return a if perm is None else a[..., perm]

    def get(name, m=None):
        a = f[name] if m is None else f[name][m]
        return _p(np.asarray(a, np.float64))

    fr = folded_rows(get, float(inp.ptsphy), c=c, fc=fc, fn=fn, fd=fd)
    names = pack_rows(fc, fn, fd, aer)
    rows = [fr[n] if n in fr else get(n.upper()) for n in names]
    col_rows = [get("PLSM"), get("LDCUM"), get("KTYPE"),
                _p(np.asarray(f["PAPH"], np.float64)[nlev])]
    return FoldedPack(
        pack=pack_expand(rows, ncol, nlev + 1, dtype, grouped),
        col=pack_expand(col_rows, ncol, 1, dtype, grouped).reshape(4, ncol),
        rows=names, fn=fn, fc=fc, fd=fd)


def k1_bytes(p: FoldedPack) -> int:
    """Modeled bytes K1 must move on pack `p`: the pack (every row of its
    form) and col in, the three output buffers out, each once."""
    return (p.pack.numel() + p.col.numel()
            + p.nlev * len(OLEV_ROWS) * p.ncol
            + (p.nlev + 1) * len(OHALF_ROWS) * p.ncol
            + p.ncol) * p.pack.element_size()


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def check_kernel_config(c) -> None:
    """Raise ValueError for a SchemeConfig the CUDA kernel does not take: a
    switch outside 1-2 or a skip tag outside scheme.SKIP_TAGS. Every one of
    the 16 scheme versions, with any aerosol coupling, any set of the skip
    tags, `dynamic_skips` on or off and `s521_round_skip` on or off, is
    taken (each a build of its own)."""
    cfg = (c.IWARMRAIN, c.IEVAPRAIN, c.IEVAPSNOW, c.IDEPICE)
    if any(v not in (1, 2) for v in cfg):
        raise ValueError(
            f"the CUDA kernel implements the SchemeConfig versions (1|2, "
            f"1|2, 1|2, 1|2); got {cfg}")
    unknown = sorted(set(c.skip) - set(scheme.SKIP_TAGS))
    if unknown:
        raise ValueError(f"unknown skip tags {unknown}; the CUDA kernel "
                         f"takes {scheme.SKIP_TAGS}")


def check_kernel_args(p: FoldedPack, c) -> None:
    """Raise ValueError for what the CUDA kernel does not take: a
    configuration `check_kernel_config` refuses, a pack whose rows are not
    its form's `pack_rows` (the version's aerosol rows included), a dtype
    other than fp32/fp64, a non-contiguous or mis-shaped buffer, or a
    tensor that is not on a CUDA device. Every form (fc, fn, fd) is
    taken."""
    check_kernel_config(c)
    if tuple(p.rows) != pack_rows(p.fc, p.fn, p.fd, aer_rows(c)):
        raise ValueError(f"unknown pack layout {p.rows} for the form "
                         f"fc={p.fc}, fn={p.fn}, fd={p.fd}")
    if p.pack.dtype not in (torch.float32, torch.float64) \
            or p.col.dtype != p.pack.dtype or c.dtype != p.pack.dtype:
        raise ValueError(f"pack {p.pack.dtype}, col {p.col.dtype} and "
                         f"constants {c.dtype} must be one of fp32/fp64")
    if p.pack.ndim != 3 or p.pack.shape[1] != len(p.rows) \
            or tuple(p.col.shape) != (4, p.ncol):
        raise ValueError(f"pack {tuple(p.pack.shape)} / col "
                         f"{tuple(p.col.shape)} do not match the layout")
    if not (p.pack.is_contiguous() and p.col.is_contiguous()):
        raise ValueError("pack and col must be contiguous")
    if p.pack.device.type != "cuda" or p.col.device != p.pack.device:
        raise ValueError("the CUDA kernel needs pack and col on one CUDA "
                         "device")


def refuse_grad(*tensors) -> None:
    """Raise if autograd is recording and a tensor requires grad: the fused
    kernel has no backward (as `jax.grad` through `pallas_call` raises), and
    its outputs would come back cut off from the graph."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            "the fused CLOUDSC kernel is not differentiable: an input "
            "requires grad. Differentiate through the eager engine instead "
            "(physics.autodiff, backend='scan', --kernel scan)")


def cloudsc_fused(p: FoldedPack, c, consts: torch.Tensor | None = None,
                  mode: str = "full", lib=None):
    """One CLOUDSC step on the folded pack -> (o_lev (nlev, 9, ncol),
    o_half (nlev+1, 10, ncol), o_prainfrac (ncol,)) on the pack's device.
    `mode` "floor" or "init" runs the diagnostic body instead of the
    physics. A CUDA pack launches the kernel (or raises); a CPU pack runs
    the plain version. `lib` is a library from `build.load_library` (if
    None, the build of `c`'s configuration on `p`'s form,
    `kernel_version(c, p.form)`). An input that requires grad is refused on
    either device (`refuse_grad`)."""
    global LAUNCHES, FLOOR_LAUNCHES, INIT_LAUNCHES
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    refuse_grad(p.pack, p.col, consts)
    if p.pack.device.type == "cpu":
        if mode == "floor":
            return cloudsc_floor_plain(p)
        if mode == "init":
            return cloudsc_init_plain(p, c)
        return cloudsc_fused_plain(p, c)
    check_kernel_args(p, c)
    if lib is None:
        from . import build

        lib = build.load_library(version=kernel_version(c, p.form))
    if consts is None:
        consts = const_vector(c, p.pack.device)
    if consts.dtype != torch.float64 or consts.device != p.pack.device \
            or consts.numel() != len(CONST_NAMES):
        raise ValueError("consts must be const_vector(c) on the pack's device")
    nlev, ncol, nrows = p.nlev, p.ncol, len(p.rows)
    o_lev = p.pack.new_empty((nlev, len(OLEV_ROWS), ncol))
    o_half = p.pack.new_empty((nlev + 1, len(OHALF_ROWS), ncol))
    o_prainfrac = p.pack.new_empty((ncol,))
    t = "f32" if p.pack.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"cloudsc_{_BODIES[mode]}_{t}")
    with torch.cuda.device(p.pack.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(p.pack.data_ptr(), p.col.data_ptr(), consts.data_ptr(),
                o_lev.data_ptr(), o_half.data_ptr(), o_prainfrac.data_ptr(),
                nlev, ncol, nrows, stream)
    if mode == "floor":
        FLOOR_LAUNCHES += 1
    elif mode == "init":
        INIT_LAUNCHES += 1
    else:
        LAUNCHES += 1
        VERSION_LAUNCHES[kernel_version(c, p.form)] += 1
    if rc != 0:
        raise RuntimeError(f"cloudsc_fused ({mode}) launch failed: CUDA "
                           f"error {rc}")
    return o_lev, o_half, o_prainfrac


OCCUPANCY_KEYS = ("blocks_per_sm", "smem_bytes", "stages", "block",
                  "min_blocks", "registers", "local_bytes")


def occupancy(dtype, lib=None) -> dict:
    """What K1 in `dtype` runs with on the current CUDA device, from the
    built library: blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    at its block and dynamic shared memory), the dynamic shared memory
    bytes a block, its ring geometry, and the registers and local-memory
    bytes a thread (cudaFuncGetAttributes). Needs a card."""
    import ctypes

    if lib is None:
        from . import build

        lib = build.load_library()
    t = "f32" if dtype == torch.float32 else "f64"
    out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    rc = getattr(lib, f"cloudsc_fused_occupancy_{t}")(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"cloudsc_fused_occupancy_{t} failed: CUDA error "
                           f"{rc}")
    return dict(zip(OCCUPANCY_KEYS, out))


def cloudsc_fused_plain(p: FoldedPack, c):
    """The plain PyTorch version of the kernel: the level loop of the Pallas
    `_kernel` / `_sub_level` / `_write_level_rows` (pallas_cloudsc.py:474-742)
    over `(ncol,)` rows, calling `scheme.level_init` / `level_step`. Runs on
    whatever device the pack is on."""
    pack, col = p.pack, p.col
    nlev, ncol = p.nlev, p.ncol
    ridx = {name: i for i, name in enumerate(p.rows)}
    aer = [n for n in p.rows if n not in pack_rows(p.fc, p.fn, p.fd)]
    curves = CURVE_ROWS if p.fc else ()
    ktop = c.NCLDTOP - 1
    zqtmst, ptsphy = c.zqtmst, c.ptsphy
    dev = pack.device

    def P(k, name):
        return pack[k, ridx[name]]

    o_lev = pack.new_empty((nlev, len(OLEV_ROWS), ncol))
    o_half = pack.new_empty((nlev + 1, len(OHALF_ROWS), ncol))
    zero = pack.new_zeros((ncol,))
    carry = scheme.initial_carry(zero, c)
    ztp1_prev = za_prev = pap_prev = zero
    a_lf = a_if = a_lng = a_nng = zero
    alf_prev = aif_prev = alng_prev = anng_prev = zero
    rain_prev = snow_prev = lnegr_prev = lnegs_prev = zero
    plsm, ldcum, ktype, paph_surf = col[0], col[1] > 0.5, \
        col[2].to(torch.int32), col[3]

    for k in range(nlev + 1):
        # section 8 flux rows for half-level k, the state before level k
        # (ref: 2788-2867); rain/snow accumulate onto the liquid/ice flux of
        # the level above (ref: 2818-2819)
        pf = carry["pfplsx"]
        o_half[k] = torch.stack([
            a_lf, a_if, a_lng, a_nng,
            alf_prev + rain_prev, aif_prev + snow_prev,
            alng_prev + lnegr_prev, anng_prev + lnegs_prev,
            pf[IR] + pf[IL], pf[IS] + pf[II],
        ])
        if k == nlev:
            break
        raw = {n: P(k, n) for n in ("ztp1_in", "zqv_in", "za_in", "pap",
                                     "pvervel", "zhr", "plude", "psnde",
                                     "psupsat", "pvfl", "pvfi", "pmf")}
        raw["zqx_cld_in"] = [P(k, f"zqx{m}_in") for m in range(4)]
        raw.update({n: P(k, n) for n in curves})
        ini = scheme.level_init(raw, c)
        paph_k, paph_k1 = P(k, "paph"), P(k + 1, "paph")
        if k < ktop:
            # above cloud top: section-1 values pass through, carries frozen
            plude_row, pcovptot_row = raw["plude"], zero
            tend_t_row, tend_q_row, tend_a_row = \
                ini["tend_t_pre"], ini["tend_q_pre"], zero
            zqxn_eff = [zero] * NCLV
        else:
            x = dict(
                ztp1=ini["ztp1"], za=ini["za"], zaorig=ini["zaorig"],
                zqx=ini["zqx"], zqsmix=ini["zqsmix"], zqsliq=ini["zqsliq"],
                zqsice=ini["zqsice"], zfoeew=ini["zfoeew"],
                zfoeewmt=ini["zfoeewmt"], zfoeeliqt=ini["zfoeeliqt"],
                zfoealfa=ini["zfoealfa"], zli=ini["zli"],
                zliqfrac=ini["zliqfrac"], zicefrac=ini["zicefrac"],
                zfoeeliq=ini["zfoeeliq"], zfoeeice=ini["zfoeeice"],
                zfokoop=ini["zfokoop"],
                tend_t_pre=ini["tend_t_pre"], tend_q_pre=ini["tend_q_pre"],
                ztp1_prev=ztp1_prev, za_prev=za_prev,
                pap=raw["pap"], pap_prev=pap_prev,
                paph=paph_k, paph_next=paph_k1, paph_surf=paph_surf,
                pmf=raw["pmf"], pmf_next=P(k + 1, "pmf"),
                plu_next=P(k + 1, "plu"),
                pvervel=raw["pvervel"], zhr=raw["zhr"],
                plude_in=raw["plude"], psnde=raw["psnde"],
                psupsat=raw["psupsat"],
                land=plsm > 0.5, ldcum=ldcum, ktype=ktype,
                not_first=torch.tensor(k > ktop, device=dev),
                not_last=torch.tensor(k < nlev - 1, device=dev),
            )
            for name in aer:
                x[name] = P(k, name)
            if p.fn:
                x["zdqs"] = P(k, ZDQS_ROW)
            if p.fd:
                x.update({n: P(k, n) for n in DEP_ROWS})
            carry, ys = scheme.level_step(x, carry, c)
            plude_row, pcovptot_row = ys["plude"], ys["pcovptot"]
            tend_t_row, tend_q_row, tend_a_row = \
                ys["tend_t"], ys["tend_q"], ys["tend_a"]
            zqxn_eff = ys["zqxn"]

        zqx0 = ini["zqx0"]
        o_lev[k] = torch.stack(
            [plude_row, pcovptot_row, tend_t_row, tend_q_row, tend_a_row]
            + [(zqxn_eff[m] - zqx0[m]) * zqtmst for m in (IL, II, IR, IS)])
        ztp1_prev, za_prev, pap_prev = ini["ztp1"], ini["za"], raw["pap"]

        # section-8 increments for this level (ref: 2798-2857)
        zgdph_r = -c.zrg_r * (paph_k1 - paph_k) * zqtmst
        zlneg = ini["zlneg"]
        liq_inc = (zqxn_eff[IL] - zqx0[IL] + raw["pvfl"] * ptsphy
                   - ini["zfoealfa"] * plude_row) * zgdph_r
        ice_inc = (zqxn_eff[II] - zqx0[II] + raw["pvfi"] * ptsphy
                   - (1.0 - ini["zfoealfa"]) * plude_row) * zgdph_r
        alf_prev, aif_prev, alng_prev, anng_prev = a_lf, a_if, a_lng, a_nng
        rain_prev = (zqxn_eff[IR] - zqx0[IR]) * zgdph_r
        snow_prev = (zqxn_eff[IS] - zqx0[IS]) * zgdph_r
        lnegr_prev = zlneg[IR] * zgdph_r
        lnegs_prev = zlneg[IS] * zgdph_r
        a_lf = a_lf + liq_inc
        a_if = a_if + ice_inc
        a_lng = a_lng + zlneg[IL] * zgdph_r
        a_nng = a_nng + zlneg[II] * zgdph_r

    return o_lev, o_half, carry["prainfrac"].clone()


def _diagnostic_outputs(v: torch.Tensor, nlev: int):
    """A diagnostic body's three buffers from its per-level value v
    (nlev+1, ncol): every row of level k holds v[k]; o_prainfrac holds the
    last level's, v[nlev] (pallas_cloudsc.py:489-509)."""
    o_lev = v[:nlev, None].expand(-1, len(OLEV_ROWS), -1).contiguous()
    o_half = v[:, None].expand(-1, len(OHALF_ROWS), -1).contiguous()
    return o_lev, o_half, v[nlev].clone()


def cloudsc_floor_plain(p: FoldedPack):
    """Plain version of the `floor` body: ztp1_in + zqv_in of level k in
    every output row of level k."""
    v = p.pack[:, p.row("ztp1_in")] + p.pack[:, p.row("zqv_in")]
    return _diagnostic_outputs(v, p.nlev)


def cloudsc_init_plain(p: FoldedPack, c):
    """Plain version of the `init` body: section 1 (`scheme.level_init`,
    elementwise, here over all levels at once) and ztp1 + zqsmix + zfokoop +
    zli in every output row of level k."""
    raw = {n: p.pack[:, p.row(n)] for n in ("ztp1_in", "zqv_in", "za_in",
                                             "pap")
           + (CURVE_ROWS if p.fc else ())}
    raw["zqx_cld_in"] = [p.pack[:, p.row(f"zqx{m}_in")] for m in range(4)]
    ini = scheme.level_init(raw, c)
    v = ini["ztp1"] + ini["zqsmix"] + ini["zfokoop"] + ini["zli"]
    return _diagnostic_outputs(v, p.nlev)


# ---------------------------------------------------------------------------
# outputs
# ---------------------------------------------------------------------------

def foldo_synthesize(half: dict, p: FoldedPack, c) -> None:
    """Rebuild the four folded-out flux rows (pallas_cloudsc.
    _foldo_synthesize): PFHPSL/N = -RLVTT/RLSTT x PFPLSL/N (ref: cloudsc.F90:
    2864-2865); PFSQLTUR/ITUR the running sums of PVFL/PVFI*PTSPHY*ZGDPH_R
    (ref: 2812-2857), added level by level in order — `torch.cumsum`'s
    parallel scan would reorder the additions."""
    nlev = p.nlev
    half["pfhpsl"] = -c.RLVTT * half["pfplsl"]
    half["pfhpsn"] = -c.RLSTT * half["pfplsn"]
    paph = p.pack[:, p.row("paph")]
    zgdph_r = -c.zrg_r * (paph[1:] - paph[:-1]) * c.zqtmst
    for name, row in (("pfsqltur", "pvfl"), ("pfsqitur", "pvfi")):
        term = p.pack[:nlev, p.row(row)] * c.ptsphy * zgdph_r
        out = torch.zeros_like(paph)
        acc = out[0]
        for k in range(nlev):
            acc = acc + term[k]
            out[k + 1] = acc
        half[name] = out


def assemble(res, p: FoldedPack, c) -> CloudscOutputs:
    """The packed output buffers -> CloudscOutputs (pallas_cloudsc._assemble),
    on the buffers' device."""
    o_lev, o_half, o_prainfrac = res
    lev = {name: o_lev[:, j] for j, name in enumerate(OLEV_ROWS)}
    half = {name: o_half[:, j] for j, name in enumerate(OHALF_ROWS)}
    foldo_synthesize(half, p, c)
    tcld = torch.stack([lev[f"tcld{m}"] for m in range(4)]
                       + [torch.zeros_like(lev["tcld0"])])
    return CloudscOutputs(
        plude=lev["plude"], pcovptot=lev["pcovptot"],
        prainfrac_toprfz=o_prainfrac,
        pfsqlf=half["pfsqlf"], pfsqif=half["pfsqif"],
        pfcqlng=half["pfcqlng"], pfcqnng=half["pfcqnng"],
        pfsqrf=half["pfsqrf"], pfsqsf=half["pfsqsf"],
        pfcqrng=half["pfcqrng"], pfcqsng=half["pfcqsng"],
        pfsqltur=half["pfsqltur"], pfsqitur=half["pfsqitur"],
        pfplsl=half["pfplsl"], pfplsn=half["pfplsn"],
        pfhpsl=half["pfhpsl"], pfhpsn=half["pfhpsn"],
        tendency_loc_t=lev["tend_t"], tendency_loc_q=lev["tend_q"],
        tendency_loc_a=lev["tend_a"], tendency_loc_cld=tcld,
    )


class FusedStep(torch.nn.Module):
    """The step with its constants held as a buffer: `derived_consts` for
    the working dtype and the kernel's flat constants vector. On the card
    it launches the build of its own scheme version (`kernel_version`)."""

    def __init__(self, params, ptsphy: float, dtype, config=None):
        super().__init__()
        self.c = scheme.derived_consts(params, ptsphy, dtype, config)
        self.register_buffer("consts", const_vector(self.c), persistent=False)

    def forward(self, p: FoldedPack):
        consts = self.consts if p.pack.is_cuda else None
        return cloudsc_fused(p, self.c, consts)

