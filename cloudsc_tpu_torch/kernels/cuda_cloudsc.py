"""The fused CLOUDSC step: input pack, CUDA kernel, plain version, outputs.

Counterpart of `cloudsc_tpu/kernels/pallas_cloudsc.py`, in every contract
the TPU kernel takes: the folded input pack (section 1's state sums and the
always-summed pairs folded in fp64 on the host) in every form (the optional
streamed saturation-curve, ZDQS and deposition rows; the main path streams
ZDQS alone), or the unfolded pack (the raw state and tendencies, summed in
the kernel at working precision: CLOUDSC_FOLD_INPUTS=0), built on the host
from a snapshot, or a plain field dict read where it lies
(`cloudsc_fused_fields`, the per-field entry); the four derivable flux rows
folded out of the outputs and rebuilt in `assemble`, or written by the
kernel (CLOUDSC_FOLD_OUTPUTS=0); on grouped or cyclic columns.
The TPU kernel it replaces is `_build` -> `pl.pallas_call(_kernel)` there; its
Hopper translation is `csrc/cloudsc_fused.cu` (with `csrc/cloudsc_scheme.cuh`),
built by `kernels/build.py`.

Layout. The host pack is `(nlev+1, nrows, ncol)` with columns contiguous:
element (k, r, j) at `(k*nrows + r)*ncol + j`, so one thread per column reads
and writes coalesced. Per-level rows carry an edge-replicated row `nlev`;
`paph` has its real surface value there. Nothing of the TPU layout carries
over (no (8, 128) tiles, no padding: the kernel bounds-checks its column).
The pack states its own layout — its row names, whether it is folded
(`fold_inputs`) and which optional rows it streams (`fc`, `fn`, `fd`) — so
no consumer infers it from a row count.

K1 has two addressing policies, one body (csrc/cloudsc_fused.cu): `Pack`
reads such a pack, and `Rows` reads a plain field dict where it lies, with
no pack: a table of the unfolded rows' base pointers and heights
(`row_table`) in the kernel's parameters, row r of level lev read at level
min(lev, h_r - 1) — the clamp gives at level nlev the values of the pack's
edge-replicated row — and PLSM, LDCUM and KTYPE in their own dtypes. A
dict must be laid out so (`rows_in_place`: contiguous `(h, ncol)` rows of
the working dtype on one device, the flags bool and int32); any other
raises, naming the row. Nothing repacks it. A dict's build (`ROWS_FORM`)
streams one more row beside the fields, ZDQS: a prologue kernel of the
same library (`zdqs_kernel`, `zdqs_row`) writes it for every (level,
column) below the cloud top at working precision (0 above, where K1 reads
none), bit for bit the in-line CUADJTQ that the column sweep would
otherwise run at its low occupancy; its plain version is `zdqs_plain`.

`cloudsc_fused` is K1's one entry, for a pack or a dict: on the card it
launches the policy of its input (or raises), through one launcher
(`_launch`); on the CPU it runs `cloudsc_fused_plain` — a level loop over
`physics.scheme` on `(ncol,)` rows that mirrors the Pallas `_kernel` /
`_sub_level` / `_write_level_rows` — on the pack, or through the dict's
row table with the kernel's clamp. Its `mode` also selects the TPU
kernel's two diagnostic bodies on a pack (`floor`, `init`: the same I/O
with degenerate or section-1 compute, for the measurement lab), with plain
versions `cloudsc_floor_plain` / `cloudsc_init_plain`. The launches are
counted in `runtime.tracing`: `ops.k1` the full body's and zdqs_kernel's
(the step's K1 layer: 2 on a dict), `launches.k1.floor` and
`launches.k1.init` the diagnostic bodies', `launches.k1.version` the full
body's by build (keyed by `KernelVersion`), `launches.k1.in_place` the full
body's on a dict, `launches.zdqs` zdqs_kernel's.

The step records its layers there too: `FusedStep.forward` is the span
`cloudsc.step`, around `cloudsc.k1` (the one `cloudsc_fused` call: a
dict's layout check and row table, the launch's checks, library lookup
and launch); `assemble` is `cloudsc.assemble`, around `cloudsc.foldo`.
Each layer counts the device operations it issues, each a kernel, copy or
fill (`ops.k1`, `ops.assemble`; `ops.pack` the device pack, `pack_inputs`,
where it is called, which the step never does), the step its `columns`,
the pack the bytes it writes (`pack_bytes`). On the card `FEED` counts, a
card at a time, the steps that found the card's queue already drained
(`feed.dry` of `feed.issues`, `Feed`). On the card `foldo_synthesize`
writes the four folded-out flux rows in one launch of `csrc/foldo.cu`
(`launches.foldo`), a library of its own; on the CPU its plain version
adds them level by level. On the card PyTorch cuts a copy into a
view that spans more than 2**31 bytes into several launches, which the
count does not see (`pack_inputs`' row copies at full width).

The kernel streams each column's input rows through a per-thread ring of
shared-memory stages filled by asynchronous copies. `RING` holds its
geometry, the same in both precisions (the build passes it to the source
as macros),
`ring_schedule` models its slots and copy groups, and `occupancy` reads
what the built kernel runs with on the card. Each version of the kernel
(`KernelVersion`: SchemeConfig's switches, skips and the aerosol couplings,
the pack's form and the output rows) is a build of its own, made at first
use; `kernel_version(c, p.form, fold_outputs)` names the one a
configuration and pack run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import numpy as np
import torch

from ..physics import satfold, scheme
from ..physics.cloudsc import CloudscOutputs
from ..physics.scheme import IL, II, IR, IS, IV, NCLV
from ..runtime import tracing

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
# the unfolded pack's rows (CLOUDSC_FOLD_INPUTS=0): pallas_cloudsc._PACK_ROWS
# (its 18 streamed fields, pclv0-3, tcld0-3) and paph, the four rows also
# read at level k+1 first; the kernel forms x + PTSPHY*tend, PMFU+PMFD and
# PHRSW+PHRLW itself
UNFOLDED_ROWS = (
    "pmfu", "pmfd", "plu", "paph",
    "pt", "pq", "tendency_tmp_t", "tendency_tmp_q", "tendency_tmp_a",
    "pa", "pap", "pvervel", "phrsw", "phrlw",
    "plude", "psnde", "psupsat", "pvfl", "pvfi",
    "pclv0", "pclv1", "pclv2", "pclv3", "tcld0", "tcld1", "tcld2", "tcld3",
)
# the forms' environment switches and defaults (pallas_cloudsc.py:223-278);
# CLOUDSC_FOLD_INPUTS=0 turns the other three off (`fold_flags`)
FOLD_ENV = (("fold_inputs", "CLOUDSC_FOLD_INPUTS", "1"),
            ("fc", "CLOUDSC_FOLD_CURVES", "0"),
            ("fn", "CLOUDSC_FOLD_NEWTON", "1"),
            ("fd", "CLOUDSC_FOLD_DEP", "0"))
# the output rows' switch and default (pallas_cloudsc.py:327)
FOLDO_ENV = ("CLOUDSC_FOLD_OUTPUTS", "1")
# per-column rows of `col`
COL_ROWS = ("plsm", "ldcum", "ktype", "paph_surf")
# rows of the per-level output buffer; the five cloud tendencies (the
# vapour's, tcld4, identically zero) are TENDENCY_LOC_CLD, which `assemble`
# returns as a view of the buffer
OLEV_ROWS = ("plude", "pcovptot", "tend_t", "tend_q", "tend_a",
             "tcld0", "tcld1", "tcld2", "tcld3", "tcld4")
TCLD0 = OLEV_ROWS.index("tcld0")
# rows of the half-level flux buffer; PFSQLTUR/PFSQITUR and PFHPSL/PFHPSN
# (FOLDO_DROP) are pure functions of streamed values and are rebuilt in
# `assemble`, unless the build writes them after the others
# (fold_outputs=False: `ohalf_rows`)
OHALF_ROWS = ("pfsqlf", "pfsqif", "pfcqlng", "pfcqnng", "pfsqrf", "pfsqsf",
              "pfcqrng", "pfcqsng", "pfplsl", "pfplsn")
FOLDO_DROP = ("pfsqltur", "pfsqitur", "pfhpsl", "pfhpsn")

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
# what only the unfolded output rows read (PFHPSL = -RLVTT x PFPLSL)
_FOLDO_NAMES = ("RLVTT",)
# The flat constants vector the kernel reads, one double each, in this
# order; csrc/cloudsc_scheme.cuh declares the matching `enum Const`.
CONST_NAMES = _C_NAMES + _THF_NAMES + _E_NAMES + tuple(_FOLDED) \
    + _ALT_NAMES + tuple(_ALT_FOLDED) + _FOLDO_NAMES


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
    `dynamic_skips`, `s521_round_skip`, the input contract (`fold_inputs`:
    the folded pack, or the unfolded one, which streams no folded row and
    may stream the ZDQS row: a field dict's build) and the output rows
    (`fold_outputs`: the four derivable flux rows left to `assemble`, or
    written by the kernel). kernels/build.py passes it to
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
    fold_inputs: bool = True
    fold_outputs: bool = True

    def __post_init__(self):
        if not self.fold_inputs and (self.fc or self.fd):
            raise ValueError(
                "the unfolded pack streams no folded row: fold_inputs="
                "False needs fc = fd = False")

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
# path's form (the folded pack with the streamed ZDQS row alone), the four
# derivable flux rows left to `assemble`, no skip
DEFAULT_VERSION = KernelVersion()


def kernel_version(c, form=None, fold_outputs: bool = True) -> KernelVersion:
    """The build that computes `derived_consts` `c`'s configuration on a
    pack of `form` ({"fold_inputs", "fc", "fn", "fd"} -> bool, each absent
    at its default, `FoldedPack.form`; the main path's, the folded pack
    with the streamed ZDQS row alone, if None), writing the four derivable
    flux rows itself unless `fold_outputs`."""
    liq = c.IWARMRAIN == 1
    return KernelVersion(
        c.IWARMRAIN, c.IEVAPRAIN, c.IEVAPSNOW, c.IDEPICE, c.LAERICESED,
        c.LAERICEAUTO, liq and c.LAERLIQAUTOLSP, liq and c.LAERLIQCOLL,
        skip=frozenset(c.skip), dynamic_skips=bool(c.dynamic_skips),
        s521_round_skip=bool(c.s521_round_skip),
        fold_outputs=bool(fold_outputs), **(form or {}))


def fold_flags() -> dict:
    """{"fold_inputs", "fc", "fn", "fd"} -> bool from CLOUDSC_FOLD_INPUTS
    / _CURVES / _NEWTON / _DEP (defaults 1 / 0 / 1 / 0, as the JAX
    package's readers); with CLOUDSC_FOLD_INPUTS=0 the other three are off
    whatever they say (pallas_cloudsc.fold_newton_enabled's `fold and`)."""
    flags = {k: os.environ.get(var, default) == "1"
             for k, var, default in FOLD_ENV}
    if not flags["fold_inputs"]:
        flags.update(fc=False, fn=False, fd=False)
    return flags


def fold_outputs_flag() -> bool:
    """CLOUDSC_FOLD_OUTPUTS (default 1): the four derivable flux rows are
    rebuilt in `assemble`; 0: the kernel writes them."""
    var, default = FOLDO_ENV
    return os.environ.get(var, default) == "1"


def ohalf_rows(fold_outputs: bool = True) -> tuple:
    """The half-level output buffer's rows: OHALF_ROWS, then FOLDO_DROP
    where the kernel writes them (`fold_outputs=False`)."""
    return OHALF_ROWS + (() if fold_outputs else FOLDO_DROP)


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
    v = {n: getattr(c, n) for n in _C_NAMES + _FOLDO_NAMES}
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
    """The input pack with its own layout: `pack (nlev+1, nrows, ncol)`,
    `col (4, ncol)`, the row names and its form: folded (`fold_inputs`) or
    the unfolded rows (UNFOLDED_ROWS), and whether it streams the
    saturation-curve rows (`fc`) and the deposition rows (`fd`), which only
    a folded pack does, and the ZDQS row (`fn`: folded in fp64, or beside
    the unfolded rows at working precision, `zdqs_plain`)."""

    pack: torch.Tensor
    col: torch.Tensor
    rows: tuple
    fn: bool
    fc: bool = False
    fd: bool = False
    fold_inputs: bool = True

    def __post_init__(self):
        if not self.fold_inputs and (self.fc or self.fd):
            raise ValueError("an unfolded pack streams no folded row")

    @property
    def form(self) -> dict:
        return {"fold_inputs": self.fold_inputs, "fc": self.fc,
                "fn": self.fn, "fd": self.fd}

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
              aer=(), fold_inputs: bool = True) -> tuple:
    """The pack's rows: folded, in pallas_cloudsc._pack_rows_f's order
    (PACK_ROWS, the curve rows (fc), ZDQS (fn), the deposition rows (fd));
    unfolded, UNFOLDED_ROWS and ZDQS (fn; no folded row: fc = fd = False);
    then `aer`."""
    if not fold_inputs:
        if fc or fd:
            raise ValueError("the unfolded pack streams no folded row: "
                             "fc = fd = False")
        return UNFOLDED_ROWS + ((ZDQS_ROW,) if fn else ()) + tuple(aer)
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


def _layout(column_order: str, perm) -> bool:
    """Whether `column_order` is grouped; refuses an unknown order and a
    source permutation of the cyclic one."""
    if column_order not in ("grouped", "cyclic"):
        raise ValueError(f"column_order {column_order!r}: grouped or cyclic")
    if perm is not None and column_order != "grouped":
        raise ValueError("perm requires column_order='grouped'")
    return column_order == "grouped"


def _snapshot_getter(inp, perm):
    """get(NAME[, species]) -> the snapshot's fp64 file-width array, source
    columns permuted by `perm`."""
    f = inp.fields

    def get(name, m=None):
        a = np.asarray(f[name] if m is None else f[name][m], np.float64)
        return a if perm is None else a[..., perm]
    return get


def _col_rows(get, nlev: int) -> list:
    return [get("PLSM"), get("LDCUM"), get("KTYPE"), get("PAPH")[nlev]]


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
    grouped = _layout(column_order, perm)
    ncol, nlev = inp.ngptot, inp.klev
    c = scheme.derived_consts(params, float(inp.ptsphy), dtype, config)
    get = _snapshot_getter(inp, perm)
    fr = folded_rows(get, float(inp.ptsphy), c=c, fc=fc, fn=fn, fd=fd)
    names = pack_rows(fc, fn, fd, aer_rows(c))
    rows = [fr[n] if n in fr else get(n.upper()) for n in names]
    return FoldedPack(
        pack=pack_expand(rows, ncol, nlev + 1, dtype, grouped),
        col=pack_expand(_col_rows(get, nlev), ncol, 1, dtype,
                        grouped).reshape(4, ncol),
        rows=names, fn=fn, fc=fc, fd=fd)


def _unfolded_source(name: str):
    """An UNFOLDED_ROWS (or aerosol) row -> (field name, species or None)."""
    if name.startswith("pclv"):
        return "pclv", int(name[4:])
    if name.startswith("tcld"):
        return "tendency_tmp_cld", int(name[4:])
    return name, None


def pack_inputs_unfolded(inp, params, config=None, dtype=torch.float32,
                         perm=None,
                         column_order: str = "grouped") -> FoldedPack:
    """The unfolded pack on the host from an unexpanded `InputData`
    (pallas_cloudsc.pack_inputs_raw with fold=False): UNFOLDED_ROWS and the
    configuration's aerosol rows, each cast to `dtype` at file width and
    expanded as `pack_inputs_folded` expands, with no arithmetic. Returns
    host tensors."""
    grouped = _layout(column_order, perm)
    ncol, nlev = inp.ngptot, inp.klev
    c = scheme.derived_consts(params, float(inp.ptsphy), dtype, config)
    get = _snapshot_getter(inp, perm)
    names = pack_rows(fn=False, aer=aer_rows(c), fold_inputs=False)
    rows = []
    for n in names:
        field, m = _unfolded_source(n)
        rows.append(get(field.upper(), m))
    return FoldedPack(
        pack=pack_expand(rows, ncol, nlev + 1, dtype, grouped),
        col=pack_expand(_col_rows(get, nlev), ncol, 1, dtype,
                        grouped).reshape(4, ncol),
        rows=names, fn=False, fold_inputs=False)


def pack_inputs_raw(inp, params, config=None, dtype=torch.float32,
                    perm=None, column_order: str = "grouped",
                    fold_inputs: bool = True, fc: bool = False,
                    fn: bool = True, fd: bool = False) -> FoldedPack:
    """The host pack of form ({fold_inputs, fc, fn, fd}, `fold_flags`):
    `pack_inputs_folded`, or `pack_inputs_unfolded` without fold_inputs
    (where fc, fn and fd must be off: the host's unfolded pack streams no
    optional row)."""
    if fold_inputs:
        return pack_inputs_folded(inp, params, config, dtype, perm, fn,
                                  column_order, fc, fd)
    if fc or fn or fd:
        raise ValueError("the host's unfolded pack streams no optional row: "
                         "fc = fn = fd = False")
    return pack_inputs_unfolded(inp, params, config, dtype, perm,
                                column_order)


def pack_inputs(fields: dict, params, config=None, ptsphy=None,
                fold: bool = False) -> FoldedPack:
    """The pack from an expanded plain field dict (`physics.cloudsc.
    make_inputs`), on the fields' device (pallas_cloudsc.pack_inputs):
    unfolded by default, whatever the environment says — the rows copied,
    each per-level row with an edge-replicated row nlev, no arithmetic.
    `fold=True` (needs `ptsphy`) folds at the fields' dtype, in the
    environment's form (`fold_flags`: fc, fn, fd), the optional rows
    computed in fp64 on the host from the fields as the JAX function
    computes them. The unfolded pack (the Pack policy's witness of what
    the Rows policy reads in place) counts its device operations in
    `ops.pack`; both count the bytes they write in `pack_bytes`."""
    pt = fields["pt"]
    dtype, dev = pt.dtype, pt.device
    nlev, ncol = pt.shape
    aer = aer_rows(scheme.derived_consts(params, 1.0, dtype, config))

    def get(name, m=None):
        a = fields[name.lower()]
        return a if m is None else a[m]

    if not fold:
        names = pack_rows(fn=False, aer=aer, fold_inputs=False)
        kw = dict(fn=False, fold_inputs=False)
        rows = [get(*_unfolded_source(n)) for n in names]
    else:
        if ptsphy is None:
            raise ValueError("a folded pack_inputs needs ptsphy")
        form = fold_flags()
        kw = {k: form[k] for k in ("fc", "fn", "fd")}
        fr = folded_rows(get, float(ptsphy))
        names = pack_rows(kw["fc"], kw["fn"], kw["fd"], aer)
        if any(kw.values()):
            # the optional rows in fp64 on the host, from the fields
            c64 = scheme.derived_consts(params, float(ptsphy), torch.float64,
                                        config)
            f64 = folded_rows(
                lambda name, m=None: get(name, m).double().cpu().numpy(),
                float(ptsphy), c64, **kw)
            fr.update({n: torch.from_numpy(f64[n]).to(dev, dtype)
                       for n in names if n in f64 and n not in fr})
        rows = [fr[n] if n in fr else fields[n] for n in names]
    pack = pt.new_empty((nlev + 1, len(names), ncol))
    for i, r in enumerate(rows):
        pack[:r.shape[0], i] = r
        if r.shape[0] == nlev:
            pack[nlev, i] = r[nlev - 1]
    cols = [fields[n] for n in COL_ROWS[:3]]
    col = torch.stack([f.to(dtype) for f in cols] + [fields["paph"][nlev]])
    if not fold:
        # a copy a row and one more for each edge row, a cast of each
        # per-column row not in the pack's dtype, the stack
        tracing.count("ops.pack", len(rows) + 1
                      + sum(r.shape[0] == nlev for r in rows)
                      + sum(f.dtype != dtype for f in cols))
    tracing.count("pack_bytes", pack.nbytes + col.nbytes)
    return FoldedPack(pack=pack, col=col, rows=names, **kw)


def k1_bytes(p: FoldedPack, fold_outputs: bool = True) -> int:
    """Modeled bytes K1 must move on pack `p`: the pack (every row of its
    form, folded or not) and col in, the three output buffers (the half
    levels' with the four derivable rows unless `fold_outputs`) out, each
    once."""
    return (p.pack.numel() + p.col.numel()
            + p.nlev * len(OLEV_ROWS) * p.ncol
            + (p.nlev + 1) * len(ohalf_rows(fold_outputs)) * p.ncol
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
    tensor that is not on a CUDA device. Every form (fold_inputs, fc, fn,
    fd) is taken."""
    check_kernel_config(c)
    if tuple(p.rows) != pack_rows(p.fc, p.fn, p.fd, aer_rows(c),
                                  p.fold_inputs):
        raise ValueError(f"unknown pack layout {p.rows} for the form "
                         f"{p.form}")
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


# the in-place input's per-column rows and their dtypes (None: the working
# dtype); the surface pressure is PAPH's level nlev
FLAG_DTYPES = (("plsm", None), ("ldcum", torch.bool), ("ktype", torch.int32))
# the form of the build that reads a field dict: the unfolded rows and the
# ZDQS row, which zdqs_kernel writes from them at working precision
ROWS_FORM = {"fold_inputs": False, "fc": False, "fn": True, "fd": False}


def row_table(fields: dict, c) -> list:
    """K1's input rows as a plain field dict holds them: [(name, tensor)]
    in the unfolded pack's order (`pack_rows(fold_inputs=False,
    aer=aer_rows(c))`), each the field's own tensor or its species slice
    (`_unfolded_source`), `(h, ncol)`: h = nlev, or nlev+1 for PAPH. The
    Rows policy of csrc/cloudsc_fused.cu and the plain version on a dict
    read row r of level lev at level min(lev, h - 1), the values the
    pack's edge-replicated row nlev holds."""
    out = []
    for name in pack_rows(fn=False, aer=aer_rows(c), fold_inputs=False):
        field, m = _unfolded_source(name)
        t = fields[field]
        out.append((name, t if m is None else t[m]))
    return out


def _in_place_table(fields: dict, c) -> list:
    """`row_table(fields, c)` where K1 can read `fields` in place
    (`rows_in_place`); else raises ValueError naming the row."""
    def refuse(why):
        return ValueError(f"K1 cannot read the field dict in place: {why}")

    pt = fields.get("pt")
    if not torch.is_tensor(pt) or pt.ndim != 2:
        raise refuse("pt is not an (nlev, ncol) tensor")
    if c.dtype not in (torch.float32, torch.float64):
        raise refuse(f"constants {c.dtype}: one of fp32/fp64")
    (nlev, ncol), dev = pt.shape, pt.device
    try:
        table = row_table(fields, c)
    except KeyError as e:
        raise refuse(f"no field {e}") from None
    for name, t in table:
        shape = (nlev + (name == "paph"), ncol)
        if t.dtype != c.dtype or t.device != dev \
                or tuple(t.shape) != shape or t.stride() != (ncol, 1):
            raise refuse(f"{name}: {t.dtype} {tuple(t.shape)} strides "
                         f"{t.stride()} on {t.device}; wanted {c.dtype} "
                         f"{shape} strides {(ncol, 1)} on {dev}")
    for name, dtype in FLAG_DTYPES:
        t, dtype = fields.get(name), dtype or c.dtype
        if not torch.is_tensor(t) or t.dtype != dtype or t.device != dev \
                or tuple(t.shape) != (ncol,) or t.stride() != (1,):
            raise refuse(f"{name}: wanted a contiguous ({ncol},) {dtype} on "
                         f"{dev}")
    return table


def rows_in_place(fields: dict, c) -> bool:
    """Whether K1 can read the plain field dict `fields` where it lies, for
    `derived_consts` `c` of fp32 or fp64: every row of `row_table` a
    contiguous `(h, ncol)` tensor, strides (ncol, 1), of the working dtype
    (`c.dtype`); PLSM a contiguous `(ncol,)` of that dtype, LDCUM bool and
    KTYPE int32; all on one device. Layout only: the device is not asked
    for. `cloudsc_fused` takes such a dict and refuses any other."""
    try:
        _in_place_table(fields, c)
    except ValueError:
        return False
    return True


def _table_args(table: list, zdqs: torch.Tensor, c) -> tuple:
    """The Rows table of the dict's build (ROWS_FORM) for the C entries:
    host arrays of the row pointers and heights in its row order, the
    dict's rows (`row_table`) with the ZDQS row `zdqs` in its place."""
    rows = dict(table, **{ZDQS_ROW: zdqs})
    names = pack_rows(fn=True, aer=aer_rows(c), fold_inputs=False)
    n = len(names)
    return ((ctypes.c_void_p * n)(*(rows[m].data_ptr() for m in names)),
            (ctypes.c_int * n)(*(rows[m].shape[0] for m in names)))


def zdqs_row(fields: dict, c) -> torch.Tensor:
    """The ZDQS row `(nlev, ncol)` of a field dict that `rows_in_place`
    takes: section 3.4b's forcing chain and in-line CUADJTQ at working
    precision for every (level, column) K1 reads (k >= NCLDTOP - 1; 0
    above), what K1's Rows policy streams. On the card one launch of
    csrc/cloudsc_fused.cu's zdqs_kernel, reading the dict in place, from
    the library `cloudsc_fused` runs on the dict by default
    (`_zdqs_launch`); on the CPU `zdqs_plain`. A dict `rows_in_place`
    refuses raises ValueError naming the row."""
    table = _in_place_table(fields, c)
    like = fields["pt"]
    if like.device.type == "cpu":
        return zdqs_plain(fields, c)
    check_kernel_config(c)
    from . import build

    lib = build.load_library(version=kernel_version(c, ROWS_FORM))
    return _zdqs_launch(table, like, c, lib)[0]


def _zdqs_launch(table: list, like: torch.Tensor, c, lib) -> tuple:
    """zdqs_kernel's launch on the current stream of `like`'s card, from
    `lib`, for the dict whose checked row table is `table`, with the
    constants of `c` in host memory (the kernel takes them as a
    parameter): (the ZDQS row, a new `like`-shaped tensor; the Rows table's
    C arrays with that row in place, which K1's launch takes). Counted in
    `launches.zdqs` and `ops.k1` (the row is K1's input, issued in its
    layer); raises on a launch error. Nothing here waits for the card: the
    constants go by value, not by a copy to the device."""
    zdqs = like.new_empty(like.shape)
    args = _table_args(table, zdqs, c)
    t = "f32" if like.dtype == torch.float32 else "f64"
    name = f"cloudsc_zdqs_rows_{t}"
    host = const_vector(c)
    with torch.cuda.device(like.device):
        rc = getattr(lib, name)(*args, host.data_ptr(), zdqs.data_ptr(),
                                *like.shape, len(args[0]),
                                torch.cuda.current_stream().cuda_stream)
    tracing.count("ops.k1")
    tracing.count("launches.zdqs")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return zdqs, args


def cloudsc_fused(x, c, consts: torch.Tensor | None = None,
                  mode: str = "full", lib=None, fold_outputs: bool = True):
    """One CLOUDSC step on a pack or a plain field dict -> (o_lev (nlev, 10
    (`OLEV_ROWS`), ncol), o_half (nlev+1, 10 or 14
    (`ohalf_rows(fold_outputs)`), ncol), o_prainfrac (ncol,)) on its
    device. A `FoldedPack` on the card launches the Pack policy; `mode`
    "floor" or "init" runs the diagnostic body instead of the physics. A field dict is read in place, with no pack,
    by the build of ROWS_FORM: on the card zdqs_kernel writes the dict's
    ZDQS row (`zdqs_row`), then the Rows policy (a table of the rows' base
    pointers and heights in the kernel's parameters, the ZDQS row's among
    them, the flags in their own dtypes; counted in
    `launches.k1.in_place`) streams it in place of the in-line CUADJTQ, two
    launches on the current stream with no sync; the full body only; a
    dict `rows_in_place` refuses raises ValueError naming the row, on
    either device. On the CPU the plain version runs, on the pack or
    through the dict's row table and `zdqs_plain`'s row. `lib` is a
    library from `build.load_library` (if None, the build of `c`'s
    configuration on the input's form and the output rows,
    `kernel_version`). An input that requires grad is refused on either
    device (`refuse_grad`)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if isinstance(x, FoldedPack):
        like, inputs = x.pack, (x.pack, x.col)
    elif mode != "full":
        raise ValueError(f"mode {mode!r}: a field dict runs the full body")
    else:
        table = _in_place_table(x, c)
        like = x["pt"]
        inputs = [t for _, t in table] + [x[n] for n, _ in FLAG_DTYPES]
    refuse_grad(*inputs, consts)
    if like.device.type == "cpu":
        if mode == "floor":
            return cloudsc_floor_plain(x, fold_outputs)
        if mode == "init":
            return cloudsc_init_plain(x, c, fold_outputs)
        return cloudsc_fused_plain(x, c, fold_outputs)
    if isinstance(x, FoldedPack):
        check_kernel_args(x, c)
        return _launch(f"cloudsc_{_BODIES[mode]}", x.form, like,
                       (x.pack.data_ptr(), x.col.data_ptr()),
                       (x.nlev, x.ncol, len(x.rows)), c, consts, lib, mode,
                       fold_outputs)
    check_kernel_config(c)
    lib, consts = _lib_consts(kernel_version(c, ROWS_FORM, fold_outputs), c,
                              consts, lib, like)
    # the row lives until K1, which reads it, is enqueued on its stream
    zdqs, args = _zdqs_launch(table, like, c, lib)
    ptrs = (*args, *(x[name].data_ptr() for name, _ in FLAG_DTYPES))
    return _launch("cloudsc_fused_rows", ROWS_FORM, like, ptrs,
                   (*like.shape, len(args[0])), c, consts, lib, mode,
                   fold_outputs)


def _lib_consts(version: KernelVersion, c, consts, lib, like):
    """(the library, the constants vector) of a launch: `lib`, or the build
    of `version`; `consts`, or `const_vector(c)` on `like`'s device, which
    it must be."""
    if lib is None:
        from . import build

        lib = build.load_library(version=version)
    if consts is None:
        consts = const_vector(c, like.device)
    if consts.dtype != torch.float64 or consts.device != like.device \
            or consts.numel() != len(CONST_NAMES):
        raise ValueError("consts must be const_vector(c) on the inputs' "
                         "device")
    return lib, consts


def _launch(entry: str, form: dict, like: torch.Tensor, ptrs: tuple,
            dims: tuple, c, consts, lib, mode: str, fold_outputs: bool):
    """K1's launch, the same for both C entry kinds (`cloudsc_<body>_<t>`
    on a pack, `cloudsc_fused_rows_<t>` on a dict's rows, whose inputs
    `cloudsc_fused` has checked): the version and its library, the
    constants vector, the three output buffers, the launch on the current
    stream of `like`'s card with the input pointers `ptrs` and `dims`
    (nlev, ncol, nrows), the counts, and the launch's error."""
    version = kernel_version(c, form, fold_outputs)
    lib, consts = _lib_consts(version, c, consts, lib, like)
    nlev, ncol, nrows = dims
    o_lev = like.new_empty((nlev, len(OLEV_ROWS), ncol))
    o_half = like.new_empty((nlev + 1, len(ohalf_rows(fold_outputs)), ncol))
    o_prainfrac = like.new_empty((ncol,))
    name = f"{entry}_{'f32' if like.dtype == torch.float32 else 'f64'}"
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(
            *ptrs, consts.data_ptr(), o_lev.data_ptr(), o_half.data_ptr(),
            o_prainfrac.data_ptr(), nlev, ncol, nrows, stream)
    if mode == "full":
        tracing.count("ops.k1")
        tracing.count("launches.k1.version", key=version)
        if entry == "cloudsc_fused_rows":
            tracing.count("launches.k1.in_place")
    else:
        tracing.count(f"launches.k1.{mode}")
    if rc != 0:
        raise RuntimeError(f"{name} ({mode}) launch failed: CUDA error {rc}")
    return o_lev, o_half, o_prainfrac


OCCUPANCY_KEYS = ("blocks_per_sm", "smem_bytes", "stages", "block",
                  "min_blocks", "registers", "local_bytes")


def occupancy(dtype, lib=None, rows: bool = False) -> dict:
    """What K1 in `dtype` runs with on the current CUDA device, from the
    built library: blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    at its block and dynamic shared memory), the dynamic shared memory
    bytes a block, its ring geometry, and the registers and local-memory
    bytes a thread (cudaFuncGetAttributes); of the Pack policy, or with
    `rows` of the Rows policy (an unfolded build's: a field dict runs
    `kernel_version(c, ROWS_FORM)`'s). Needs a card."""
    if lib is None:
        from . import build

        lib = build.load_library()
    t = "f32" if dtype == torch.float32 else "f64"
    name = f"cloudsc_fused{'_rows' if rows else ''}_occupancy_{t}"
    out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
    rc = getattr(lib, name)(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    return dict(zip(OCCUPANCY_KEYS, out))


def _state_raw(get, form: dict) -> dict:
    """Section 1's inputs (`scheme.level_init`'s `raw`) through `get(row)`
    for an input of `form` (`FoldedPack.form`): the folded contract
    (ztp1_in, zqv_in, za_in, zqx_cld_in, and the curve rows of the fc
    form), or the unfolded one (pt, pq, pa, the tendencies, pclv), whose
    x + PTSPHY*tend level_init forms at working precision."""
    if form["fold_inputs"]:
        raw = {n: get(n) for n in ("ztp1_in", "zqv_in", "za_in", "pap")
               + (CURVE_ROWS if form["fc"] else ())}
        raw["zqx_cld_in"] = [get(f"zqx{m}_in") for m in range(4)]
        return raw
    raw = {n: get(n) for n in ("pt", "pq", "pa", "pap", "tendency_tmp_t",
                               "tendency_tmp_q", "tendency_tmp_a")}
    raw["pclv"] = [get(f"pclv{m}") for m in range(4)]
    raw["tendency_tmp_cld"] = [get(f"tcld{m}") for m in range(4)]
    return raw


def _pmf(get, form: dict):
    """PMFU+PMFD through `get(row)`: the folded row, or the sum at working
    precision (pallas_cloudsc._sub_level's `raw["pmfu"] + raw["pmfd"]`)."""
    return get("pmf") if form["fold_inputs"] else get("pmfu") + get("pmfd")


def zdqs_plain(fields: dict, c) -> torch.Tensor:
    """The plain version of zdqs_kernel (`zdqs_row`) on a field dict that
    `rows_in_place` takes: level by level on `(ncol,)` rows read through its
    `row_table` with the kernel's clamp, each input of
    `scheme.cuadj_zdqs` formed as the plain K1 forms it (`level_init`'s
    ZTP1 and `sat_mix`, the level loop's PAPH difference and PMFU+PMFD of
    levels k and k+1): term for term `scheme.level_step`'s in-line chain,
    on every level K1 reads (k >= NCLDTOP - 1), and 0 above. Runs on the
    dict's device."""
    rows = dict(row_table(fields, c))
    pt = fields["pt"]
    nlev = pt.shape[0]

    def P(k, name):
        t = rows[name]
        return t[min(k, t.shape[0] - 1)]

    out = torch.zeros_like(pt)
    for k in range(c.NCLDTOP - 1, nlev):
        ztp1 = P(k, "pt") + c.ptsphy * P(k, "tendency_tmp_t")
        pap = P(k, "pap")
        zqsmix = scheme.sat_mix(ztp1, scheme.foealfa(ztp1, c.thf), pap, c)[3]
        out[k] = scheme.cuadj_zdqs(
            ztp1, pap, P(k + 1, "paph") - P(k, "paph"),
            P(k, "pmfu") + P(k, "pmfd"), P(k + 1, "pmfu") + P(k + 1, "pmfd"),
            torch.tensor(k < nlev - 1, device=pt.device), P(k, "pvervel"),
            P(k, "phrsw") + P(k, "phrlw"), zqsmix, c)
    return out


def cloudsc_fused_plain(x, c, fold_outputs: bool = True):
    """The plain PyTorch version of the kernel: the level loop of the Pallas
    `_kernel` / `_sub_level` / `_write_level_rows` (pallas_cloudsc.py:474-742)
    over `(ncol,)` rows, calling `scheme.level_init` / `level_step`, on a
    folded or an unfolded pack, or on a plain field dict that
    `rows_in_place` takes, read as the Rows policy reads it: through its
    `row_table` and the ZDQS row `zdqs_plain` makes of it, row r of level
    lev at level min(lev, h_r - 1), PLSM, LDCUM and KTYPE in their own
    dtypes. Without `fold_outputs` it also writes the four derivable flux
    rows (PFSQLTUR/ITUR as running sums, PFHPSL/N from PFPLSL/N). Runs on
    whatever device the input is on."""
    if isinstance(x, FoldedPack):
        like, nlev, form = x.pack, x.nlev, x.form
        ridx = {name: i for i, name in enumerate(x.rows)}
        aer = x.rows[len(pack_rows(x.fc, x.fn, x.fd, (), x.fold_inputs)):]

        def P(k, name):
            return x.pack[k, ridx[name]]

        plsm, ldcum, ktype, paph_surf = x.col[0], x.col[1] > 0.5, \
            x.col[2].to(torch.int32), x.col[3]
    else:
        like, form, aer = x["pt"], ROWS_FORM, aer_rows(c)
        nlev = like.shape[0]
        rows = dict(row_table(x, c), **{ZDQS_ROW: zdqs_plain(x, c)})

        def P(k, name):
            t = rows[name]
            return t[min(k, t.shape[0] - 1)]

        plsm, ldcum, ktype, paph_surf = x["plsm"], x["ldcum"], x["ktype"], \
            x["paph"][nlev]
    ncol = like.shape[-1]
    ktop = c.NCLDTOP - 1
    zqtmst, ptsphy = c.zqtmst, c.ptsphy
    dev = like.device

    o_lev = like.new_empty((nlev, len(OLEV_ROWS), ncol))
    o_half = like.new_empty((nlev + 1, len(ohalf_rows(fold_outputs)), ncol))
    zero = like.new_zeros((ncol,))
    carry = scheme.initial_carry(zero, c)
    ztp1_prev = za_prev = pap_prev = zero
    a_lf = a_if = a_lng = a_nng = a_ltur = a_itur = zero
    alf_prev = aif_prev = alng_prev = anng_prev = zero
    rain_prev = snow_prev = lnegr_prev = lnegs_prev = zero

    for k in range(nlev + 1):
        # section 8 flux rows for half-level k, the state before level k
        # (ref: 2788-2867); rain/snow accumulate onto the liquid/ice flux of
        # the level above (ref: 2818-2819)
        pf = carry["pfplsx"]
        pfplsl, pfplsn = pf[IR] + pf[IL], pf[IS] + pf[II]
        half = [a_lf, a_if, a_lng, a_nng,
                alf_prev + rain_prev, aif_prev + snow_prev,
                alng_prev + lnegr_prev, anng_prev + lnegs_prev,
                pfplsl, pfplsn]
        if not fold_outputs:
            half += [a_ltur, a_itur, -c.RLVTT * pfplsl, -c.RLSTT * pfplsn]
        o_half[k] = torch.stack(half)
        if k == nlev:
            break

        def get(name):
            return P(k, name)

        raw = _state_raw(get, form)
        raw.update({n: get(n) for n in ("pvervel", "plude", "psnde",
                                         "psupsat", "pvfl", "pvfi")})
        ini = scheme.level_init(raw, c)
        paph_k, paph_k1 = P(k, "paph"), P(k + 1, "paph")
        if k < ktop:
            # above cloud top: section-1 values pass through, carries frozen
            plude_row, pcovptot_row = raw["plude"], zero
            tend_t_row, tend_q_row, tend_a_row = \
                ini["tend_t_pre"], ini["tend_q_pre"], zero
            zqxn_eff = [zero] * NCLV
        else:
            y = dict(
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
                pmf=_pmf(get, form),
                pmf_next=_pmf(lambda n: P(k + 1, n), form),
                plu_next=P(k + 1, "plu"),
                pvervel=raw["pvervel"],
                zhr=get("zhr") if form["fold_inputs"]
                else get("phrsw") + get("phrlw"),
                plude_in=raw["plude"], psnde=raw["psnde"],
                psupsat=raw["psupsat"],
                land=plsm > 0.5, ldcum=ldcum, ktype=ktype,
                not_first=torch.tensor(k > ktop, device=dev),
                not_last=torch.tensor(k < nlev - 1, device=dev),
            )
            for name in aer:
                y[name] = P(k, name)
            if form["fn"]:
                y["zdqs"] = P(k, ZDQS_ROW)
            if form["fd"]:
                y.update({n: P(k, n) for n in DEP_ROWS})
            carry, ys = scheme.level_step(y, carry, c)
            plude_row, pcovptot_row = ys["plude"], ys["pcovptot"]
            tend_t_row, tend_q_row, tend_a_row = \
                ys["tend_t"], ys["tend_q"], ys["tend_a"]
            zqxn_eff = ys["zqxn"]

        zqx0 = ini["zqx0"]
        o_lev[k] = torch.stack(
            [plude_row, pcovptot_row, tend_t_row, tend_q_row, tend_a_row]
            + [(zqxn_eff[m] - zqx0[m]) * zqtmst for m in (IL, II, IR, IS)]
            + [zero])
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
        if not fold_outputs:
            # the input-only running sums (foldo_synthesize's recurrence)
            a_ltur = a_ltur + raw["pvfl"] * ptsphy * zgdph_r
            a_itur = a_itur + raw["pvfi"] * ptsphy * zgdph_r

    return o_lev, o_half, carry["prainfrac"].clone()


def _diagnostic_outputs(v: torch.Tensor, nlev: int,
                        fold_outputs: bool = True):
    """A diagnostic body's three buffers from its per-level value v
    (nlev+1, ncol): every row of level k holds v[k] but the vapour's cloud
    tendency, 0 as the full body writes it; o_prainfrac holds the last
    level's, v[nlev] (pallas_cloudsc.py:489-509)."""
    o_lev = v[:nlev, None].expand(-1, len(OLEV_ROWS), -1).contiguous()
    o_lev[:, TCLD0 + IV] = 0
    o_half = v[:, None].expand(-1, len(ohalf_rows(fold_outputs)),
                               -1).contiguous()
    return o_lev, o_half, v[nlev].clone()


def cloudsc_floor_plain(p: FoldedPack, fold_outputs: bool = True):
    """Plain version of the `floor` body: ztp1_in + zqv_in (pt + pq on an
    unfolded pack) of level k in every output row of level k."""
    a, b = ("ztp1_in", "zqv_in") if p.fold_inputs else ("pt", "pq")
    v = p.pack[:, p.row(a)] + p.pack[:, p.row(b)]
    return _diagnostic_outputs(v, p.nlev, fold_outputs)


def cloudsc_init_plain(p: FoldedPack, c, fold_outputs: bool = True):
    """Plain version of the `init` body: section 1 (`scheme.level_init`,
    elementwise, here over all levels at once) and ztp1 + zqsmix + zfokoop +
    zli in every output row of level k."""
    ini = scheme.level_init(
        _state_raw(lambda n: p.pack[:, p.row(n)], p.form), c)
    v = ini["ztp1"] + ini["zqsmix"] + ini["zfokoop"] + ini["zli"]
    return _diagnostic_outputs(v, p.nlev, fold_outputs)


# ---------------------------------------------------------------------------
# outputs
# ---------------------------------------------------------------------------

def _flux_inputs(src):
    """(paph (nlev+1, ncol), pvfl (nlev, ncol), pvfi (nlev, ncol)) of a
    pack or a plain field dict."""
    if isinstance(src, FoldedPack):
        nlev = src.nlev
        return (src.pack[:, src.row("paph")], src.pack[:nlev, src.row("pvfl")],
                src.pack[:nlev, src.row("pvfi")])
    return src["paph"], src["pvfl"], src["pvfi"]


def foldo_synthesize_plain(half: dict, src, c) -> None:
    """The plain version of `foldo_synthesize`, on whatever device `src`
    is on: PFHPSL/N one multiply each, PFSQLTUR/ITUR added level by level
    in order — `torch.cumsum`'s parallel scan would reorder the
    additions."""
    half["pfhpsl"] = -c.RLVTT * half["pfplsl"]
    half["pfhpsn"] = -c.RLSTT * half["pfplsn"]
    paph, pvfl, pvfi = _flux_inputs(src)
    zgdph_r = -c.zrg_r * (paph[1:] - paph[:-1]) * c.zqtmst
    for name, rows in (("pfsqltur", pvfl), ("pfsqitur", pvfi)):
        term = rows * c.ptsphy * zgdph_r
        out = torch.zeros_like(paph)
        acc = out[0]
        for k in range(paph.shape[0] - 1):
            acc = acc + term[k]
            out[k + 1] = acc
        half[name] = out
    # the two scalings, ZGDPH_R's three, and a row's two products, its
    # zeros and an add and a copy a level
    tracing.count("ops.assemble", 5 + 2 * (3 + 2 * (paph.shape[0] - 1)))


# the rows csrc/foldo.cu writes, in the order of its output planes
FOLDO_ROWS = ("pfhpsl", "pfhpsn", "pfsqltur", "pfsqitur")


def check_foldo_args(paph, pvfl, pvfi, pfplsl, pfplsn) -> None:
    """Raise ValueError unless the rows are what csrc/foldo.cu takes: one
    type, fp32 or fp64; PAPH, PFPLSL and PFPLSN (nlev+1, ncol), PVFL and
    PVFI (nlev, ncol); contiguous columns (any level stride); all on one
    CUDA device."""
    rows = {"paph": paph, "pvfl": pvfl, "pvfi": pvfi, "pfplsl": pfplsl,
            "pfplsn": pfplsn}
    if paph.dtype not in (torch.float32, torch.float64) \
            or any(r.dtype != paph.dtype for r in rows.values()):
        raise ValueError("the flux rows must share one type, fp32 or fp64: "
                         + ", ".join(f"{n} {r.dtype}"
                                     for n, r in rows.items()))
    nlev, ncol = paph.shape[0] - 1, paph.shape[-1]
    for name, r in rows.items():
        want = (nlev if name in ("pvfl", "pvfi") else nlev + 1, ncol)
        if tuple(r.shape) != want:
            raise ValueError(f"{name} {tuple(r.shape)}: expected {want} "
                             f"(paph {tuple(paph.shape)})")
        if r.stride(1) != 1:
            raise ValueError(f"{name}: the columns must be contiguous "
                             f"(strides {r.stride()})")
    if paph.device.type != "cuda" \
            or any(r.device != paph.device for r in rows.values()):
        raise ValueError("the kernel needs the flux rows on one CUDA device: "
                         + ", ".join(f"{n} {r.device}"
                                     for n, r in rows.items()))


@functools.cache
def _foldo_entry(dtype):
    """csrc/foldo.cu's entry point for `dtype`, from its own library (built
    at first use, whatever K1's version), looked up once."""
    from . import build

    t = "f32" if dtype == torch.float32 else "f64"
    lib = build.load_library(sources=[build.CSRC / "foldo.cu"])
    return getattr(lib, f"cloudsc_foldo_{t}")


def foldo_synthesize(half: dict, src, c) -> None:
    """Rebuild the four folded-out flux rows (pallas_cloudsc.
    _foldo_synthesize) from `src`, the step's pack or field dict:
    PFHPSL/N = -RLVTT/RLSTT x PFPLSL/N (ref: cloudsc.F90: 2864-2865);
    PFSQLTUR/ITUR the running sums of PVFL/PVFI*PTSPHY*ZGDPH_R (ref:
    2812-2857). On the card one launch of csrc/foldo.cu writes the four
    rows, bit for bit with the plain version (or raises,
    `check_foldo_args`); on the CPU the plain version runs."""
    paph, pvfl, pvfi = _flux_inputs(src)
    if paph.device.type == "cpu":
        foldo_synthesize_plain(half, src, c)
        return
    rows = (paph, pvfl, pvfi, half["pfplsl"], half["pfplsn"])
    check_foldo_args(*rows)
    nlev, ncol = pvfl.shape
    out = paph.new_empty((len(FOLDO_ROWS), nlev + 1, ncol))
    fn = _foldo_entry(paph.dtype)
    with torch.cuda.device(paph.device):
        rc = fn(*(r.data_ptr() for r in rows), *(r.stride(0) for r in rows),
                out.data_ptr(), nlev, ncol, -c.zrg_r, c.zqtmst, c.ptsphy,
                -c.RLVTT, -c.RLSTT, torch.cuda.current_stream().cuda_stream)
    tracing.count("ops.assemble")
    tracing.count("launches.foldo")
    if rc != 0:
        raise RuntimeError(f"cloudsc_foldo launch failed: CUDA error {rc}")
    half.update(zip(FOLDO_ROWS, out))


def assemble(res, src, c, fold_outputs: bool = True) -> CloudscOutputs:
    """The packed output buffers -> CloudscOutputs (pallas_cloudsc._assemble),
    on the buffers' device. The four derivable flux rows are rebuilt from
    `src` (the step's pack or field dict, `foldo_synthesize`) where the
    build left them out (`fold_outputs`), and read from the buffer where it
    wrote them. Every output is a view of the buffers, TENDENCY_LOC_CLD
    too: K1's five cloud-tendency rows, `(NCLV, nlev, ncol)` with strides
    `(ncol, len(OLEV_ROWS) * ncol, 1)`."""
    with tracing.span("cloudsc.assemble"):
        o_lev, o_half, o_prainfrac = res
        lev = {name: o_lev[:, j] for j, name in enumerate(OLEV_ROWS)}
        half = {name: o_half[:, j]
                for j, name in enumerate(ohalf_rows(fold_outputs))}
        if fold_outputs:
            with tracing.span("cloudsc.foldo"):
                foldo_synthesize(half, src, c)
        tcld = o_lev[:, TCLD0:TCLD0 + NCLV].transpose(0, 1)
        FEED.issued(o_lev.device)
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


class Feed:
    """Whether the host keeps each card fed. Where the port finishes
    issuing a step's work on a card (after K1 in `FusedStep.forward`, and
    again after `assemble` where it runs) it records the card's event on
    the card's current stream; when `FusedStep.forward` begins the card's
    next step it queries that event without blocking and counts
    `feed.issues`, and `feed.dry` where the event has completed: the card
    ran out of the port's work before the host gave it more. Both keyed by
    the card's index, in `runtime.tracing`. Each card has one event, made
    at its first record and recorded again each time (a record replaces
    the last one's state), so a step costs one query and one or two
    records, with no sync and no allocation. Nothing is counted on the
    CPU, nor while a profiler records (the step's record is dropped then,
    so the next step is not held against a traced one). `event` makes a
    card's event (`torch.cuda.Event`, timing off)."""

    def __init__(self, event=torch.cuda.Event):
        self.event = event
        self.events: dict = {}   # card index -> its event
        self.last: dict = {}     # card index -> its event, once recorded

    def issued(self, dev: torch.device) -> None:
        if dev.type != "cuda":
            return
        if tracing.profiling():
            self.last.pop(dev.index, None)
            return
        ev = self.events.get(dev.index)
        if ev is None:
            ev = self.events[dev.index] = self.event()
        ev.record(torch.cuda.current_stream(dev))
        self.last[dev.index] = ev

    def check(self, dev: torch.device) -> None:
        if dev.type != "cuda":
            return
        ev = self.last.pop(dev.index, None)
        if ev is None or tracing.profiling():
            return
        tracing.count("feed.issues", key=dev.index)
        if ev.query():
            tracing.count("feed.dry", key=dev.index)


# the process's feed: the cards' queues are the process's
FEED = Feed()


class FusedStep(torch.nn.Module):
    """The step with its constants held as a buffer: `derived_consts` for
    the working dtype and the kernel's flat constants vector. It takes a
    pack, or a plain field dict, and returns the raw buffers (`assemble`
    takes the same pack or dict) of one `cloudsc_fused` call: on the card
    the build of its own scheme version, the input's form and its output
    rows (`kernel_version`), a dict read in place; a dict that
    `rows_in_place` refuses raises. It never packs."""

    def __init__(self, params, ptsphy: float, dtype, config=None,
                 fold_outputs: bool = True):
        super().__init__()
        self.fold_outputs = fold_outputs
        self.c = scheme.derived_consts(params, ptsphy, dtype, config)
        self.register_buffer("consts", const_vector(self.c), persistent=False)
        self._copies = {}

    def consts_on(self, dev) -> torch.Tensor:
        """The constants vector on `dev`: the buffer, or a copy made once
        for another device (the shares of a mesh)."""
        if dev == self.consts.device:
            return self.consts
        c = self._copies.get(dev)
        if c is None:
            c = self._copies[dev] = const_vector(self.c, dev)
        return c

    def forward(self, x):
        with tracing.span("cloudsc.step"):
            like = x.pack if isinstance(x, FoldedPack) else x["pt"]
            FEED.check(like.device)
            tracing.count("columns", like.shape[-1])
            with tracing.span("cloudsc.k1"):
                res = cloudsc_fused(x, self.c, self.consts_on(like.device),
                                    fold_outputs=self.fold_outputs)
            FEED.issued(like.device)
            return res


def cloudsc_fused_fields(fields: dict, params, ptsphy, config=None,
                         fold_outputs: bool | None = None) -> CloudscOutputs:
    """The per-field entry (pallas_cloudsc.cloudsc_pallas on a field dict):
    one step over a plain `make_inputs` field dict, on the fields' device —
    the `physics.cloudsc` contract, through `FusedStep`: the dict read in
    place (`cloudsc_fused`: on the card zdqs_kernel, then the Rows policy
    of the dict's build, `ROWS_FORM`; on the CPU the plain version through
    its row table and `zdqs_plain`), with no pack; a dict `rows_in_place`
    refuses raises.
    `fold_outputs` (default: CLOUDSC_FOLD_OUTPUTS) leaves the four
    derivable flux rows to `assemble`."""
    fo = fold_outputs_flag() if fold_outputs is None else fold_outputs
    step = FusedStep(params, ptsphy, fields["pt"].dtype, config, fo)
    return assemble(step.to(fields["pt"].device)(fields), fields, step.c, fo)
