"""Golden-file validation: per-field error norms + the reference's table format.

Counterpart of `cloudsc_tpu/validate.py`. Per field: min,
max, AbsMaxErr, AvgAbsErr/GP, MaxRelErr-%, with a ' !!!!' flag when the
relative error exceeds 10*machine-eps of the working precision (ref:
src/common/module/validate_mod.F90:263-296; header print ref:
src/common/module/cloudsc_global_state_mod.F90:296-299).

Two paths give the same table: `validate_outputs` on host arrays (numpy),
and, for outputs left on the card, `device_field_norms` (the five norms of
every field, reduced in fp64 where the outputs lie; only the (21, 5) rows
leave the device; on a mesh one set a device, reduced on the host)
followed by `validate_from_norms`. The reference the device path compares
against is put on the card at file width, cut to the rank's slice and
expanded there (`reference_on_device`), so the host never holds it at the
run's width. Over several ranks both reduce the norms across the ranks
(`multiprocess`, `runtime.dist.allreduce_field_norms`) before the table is
made, and only rank 0 prints it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# validation order and field dimensionality (ref: cloudsc_global_state_mod.F90:324-345)
VALIDATION_ORDER = [
    ("PLUDE", 2), ("PCOVPTOT", 2), ("PRAINFRAC_TOPRFZ", 1),
    ("PFSQLF", 2), ("PFSQIF", 2), ("PFCQLNG", 2), ("PFCQNNG", 2),
    ("PFSQRF", 2), ("PFSQSF", 2), ("PFCQRNG", 2), ("PFCQSNG", 2),
    ("PFSQLTUR", 2), ("PFSQITUR", 2),
    ("PFPLSL", 2), ("PFPLSN", 2), ("PFHPSL", 2), ("PFHPSN", 2),
    ("TENDENCY_LOC%A", 2), ("TENDENCY_LOC%Q", 2), ("TENDENCY_LOC%T", 2),
    ("TENDENCY_LOC%CLD", 3),
]

# output-struct attribute for each validated name
FIELD_ATTR = {
    "PLUDE": "plude", "PCOVPTOT": "pcovptot",
    "PRAINFRAC_TOPRFZ": "prainfrac_toprfz",
    "PFSQLF": "pfsqlf", "PFSQIF": "pfsqif",
    "PFCQLNG": "pfcqlng", "PFCQNNG": "pfcqnng",
    "PFSQRF": "pfsqrf", "PFSQSF": "pfsqsf",
    "PFCQRNG": "pfcqrng", "PFCQSNG": "pfcqsng",
    "PFSQLTUR": "pfsqltur", "PFSQITUR": "pfsqitur",
    "PFPLSL": "pfplsl", "PFPLSN": "pfplsn",
    "PFHPSL": "pfhpsl", "PFHPSN": "pfhpsn",
    "TENDENCY_LOC%A": "tendency_loc_a",
    "TENDENCY_LOC%Q": "tendency_loc_q",
    "TENDENCY_LOC%T": "tendency_loc_t",
    "TENDENCY_LOC%CLD": "tendency_loc_cld",
}

REF_DATASET = {name: name.replace("%", "_") for name in FIELD_ATTR}


@dataclasses.dataclass
class FieldErrors:
    name: str
    ndim: int
    minval: float
    maxval: float
    maxerr: float
    errsum: float
    refsum: float
    avgpgp: float
    # epsilon of the WORKING precision: the reference's threshold is
    # 10*EPSILON(1.0_JPRB) (ref: validate_mod.F90:270,289)
    eps: float = float(np.finfo(np.float64).eps)

    @property
    def relerr(self) -> float:
        """Relative error variant selection (ref: validate_mod.F90:273-283):
        an absolute errsum below eps reads as 0 whatever the refsum."""
        if self.errsum < self.eps:
            return 0.0
        if self.refsum < self.eps:
            return self.errsum / (1.0 + self.refsum)
        return self.errsum / self.refsum

    @property
    def flagged(self) -> bool:
        # non-finite stats are flagged (the Fortran's > comparison would
        # let a NaN through; ref: validate_mod.F90:287-290)
        if not all(map(math.isfinite, (self.maxerr, self.errsum, self.refsum))):
            return True
        return self.relerr > 10.0 * self.eps


def field_errors(name: str, field, ref, ngptotg: int | None = None) -> FieldErrors:
    """Error statistics for one field (ref: validate_mod.F90 VALIDATE_R1/R2/R3),
    in numpy on the host."""
    field = np.asarray(field)
    work_eps = float(np.finfo(field.dtype).eps) if np.issubdtype(
        field.dtype, np.floating) else float(np.finfo(np.float64).eps)
    field = np.asarray(field, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    n = ngptotg if ngptotg is not None else field.shape[-1]
    diff = np.abs(field - ref)
    errsum = float(diff.sum())
    return FieldErrors(
        name=name, ndim=field.ndim,
        minval=float(field.min()), maxval=float(field.max()),
        maxerr=float(diff.max()), errsum=errsum,
        refsum=float(np.abs(ref).sum()), avgpgp=errsum / n, eps=work_eps,
    )


def _e20_13(x: float) -> str:
    """Fortran E20.13 formatting: 0.XXXXXXXXXXXXXE+ee in a 20-char field;
    non-finite values print as gfortran's E edit descriptor does."""
    if math.isnan(x):
        return "NaN".rjust(20)
    if math.isinf(x):
        return ("-Infinity" if x < 0 else "Infinity").rjust(20)
    if x == 0.0:
        return "0.0000000000000E+00".rjust(20)
    neg = x < 0.0
    ax = abs(x)
    exp = int(math.floor(math.log10(ax))) + 1
    mant = ax / 10.0**exp
    # rounding may push the mantissa to 1.0
    mant_str = f"{mant:.13f}"
    if mant_str.startswith("1"):
        exp += 1
        mant = ax / 10.0**exp
        mant_str = f"{mant:.13f}"
    body = f"0.{mant_str[2:]}E{exp:+03d}"
    if neg:
        body = "-" + body
    return body.rjust(20)


def error_line(errs: FieldErrors) -> str:
    """One validation row (ref: validate_mod.F90:292-294 format 1000)."""
    iopt = 1 if errs.errsum < errs.eps else (
        2 if errs.refsum < errs.eps else 3
    )
    clwarn = " !!!!" if errs.flagged else ""
    vals = "".join(
        " " + _e20_13(v)
        for v in (errs.minval, errs.maxval, errs.maxerr, errs.avgpgp,
                  100.0 * errs.relerr)
    )
    return f" {errs.name:<20s} {errs.ndim}D{iopt}{vals}{clwarn}"


def validation_header() -> str:
    names = ["MinValue", "MaxValue", "AbsMaxErr", "AvgAbsErr/GP", "MaxRelErr-%"]
    return " " + f"{'Variable':<20s} {'Dim':<3s}" + "".join(f" {n:<20s}" for n in names)


def _print_table(results) -> None:
    """The table, on rank 0 only (the reference's rank-0-gated print)."""
    from .runtime import dist

    if dist.rank() == 0:
        print("\n".join([validation_header()]
                        + [error_line(errs) for errs in results]))


def _from_rows(rows, ngptotg: int, work_eps: float) -> list[FieldErrors]:
    return [
        FieldErrors(name=name, ndim=ndim, minval=float(r[0]),
                    maxval=float(r[1]), maxerr=float(r[2]),
                    errsum=float(r[3]), refsum=float(r[4]),
                    avgpgp=float(r[3]) / float(ngptotg), eps=work_eps)
        for (name, ndim), r in zip(VALIDATION_ORDER, rows)
    ]


def validate_outputs(outputs, reference: dict, ngptotg: int | None = None,
                     print_table: bool = True,
                     multiprocess: bool = False) -> list[FieldErrors]:
    """Validate a CloudscOutputs of host arrays against the reference dict.
    With `multiprocess` the (21, 5) norms are reduced across the ranks
    first (`dist.allreduce_field_norms`), so every rank gets the global
    table (ref: validate_mod.F90:148-151)."""
    results = [
        field_errors(name, getattr(outputs, FIELD_ATTR[name]),
                     reference[REF_DATASET[name]], ngptotg=ngptotg)
        for name, _ in VALIDATION_ORDER
    ]
    if multiprocess:
        from .runtime.dist import allreduce_field_norms

        if ngptotg is None:
            raise ValueError("a table reduced over ranks needs the global "
                             "column count ngptotg")
        rows = allreduce_field_norms([[e.minval, e.maxval, e.maxerr,
                                       e.errsum, e.refsum] for e in results])
        results = _from_rows(rows, ngptotg, results[0].eps)
    if print_table:
        _print_table(results)
    return results


def device_field_norms(outputs, reference):
    """All 21 fields' (min, max, maxerr, errsum, refsum) as one (21, 5)
    float64 tensor. `outputs` is a CloudscOutputs of tensors and
    `reference` the REF_DATASET-keyed tensors on the same device
    (`reference_on_device`): the norms are reduced there and the table
    stays on that device. Each field and its reference are taken in fp64
    and |f - r| and the sums are formed in fp64, as `field_errors` does on
    the host; columns beyond the reference's are dropped.

    On a mesh both are lists, one a device (a CloudscOutputs and its
    reference shard): each device reduces its own shard and the (21, 5)
    rows are reduced on the host (`dist.reduce_norms`); the table comes
    back on the host. Recorded as the span `cloudsc.validate`
    (`runtime.tracing`)."""
    import torch

    from .runtime import tracing
    from .runtime.dist import reduce_norms

    with tracing.span("cloudsc.validate"):
        if isinstance(outputs, (list, tuple)) \
                and not hasattr(outputs, "_fields"):
            return torch.from_numpy(reduce_norms(
                [_field_norms(o, r).cpu().numpy()
                 for o, r in zip(outputs, reference)]))
        return _field_norms(outputs, reference)


def _field_norms(outputs, reference):
    """One device's (21, 5) table (`device_field_norms`)."""
    import torch

    from .runtime.dist import error_norms

    rows = []
    for name, _ in VALIDATION_ORDER:
        r = reference[REF_DATASET[name]]
        f = getattr(outputs, FIELD_ATTR[name])[..., : r.shape[-1]]
        rows.append(error_norms(f, r))
    return torch.stack(rows)


def validate_from_norms(norms, ngptotg: int, print_table: bool = True,
                        work_eps: float | None = None,
                        multiprocess: bool = False) -> list[FieldErrors]:
    """The validation table from precomputed (21, 5) norm rows (the device
    path). `work_eps` is the run's working-precision epsilon: an fp32 run
    flags at 10*sp-eps like the reference's single-precision build (ref:
    validate_mod.F90:270). With `multiprocess` the rows are reduced across
    the ranks first (`dist.allreduce_field_norms`)."""
    norms = np.asarray(norms, dtype=np.float64)
    if work_eps is None:
        work_eps = float(np.finfo(np.float64).eps)
    if multiprocess:
        from .runtime.dist import allreduce_field_norms

        norms = allreduce_field_norms(norms)
    results = _from_rows(norms, ngptotg, work_eps)
    if print_table:
        _print_table(results)
    return results


def reference_on_device(path, ngptot: int, device, ngptotg: int | None = None,
                        rank: int = 0, nranks: int = 1,
                        columns: tuple[int, int] | None = None) -> dict:
    """The golden outputs on `device`, in fp64, expanded there to `ngptot`
    columns with `data.load_reference`'s index: the file's columns first
    cut to this rank's slice by the loaders' rule (`ngptotg`, `rank`,
    `nranks`; `expand.get_offsets`), then column j holds slice column
    j % width. `columns=(start, stop)` keeps only those columns of the
    expansion (a mesh device's share). Only the file-width arrays cross
    from the host."""
    import torch

    from . import data
    from .data.expand import get_offsets

    raw = data.load_reference(path)
    start, stop = columns if columns is not None else (0, ngptot)
    out = {}
    for name, a in raw.items():
        a = np.asarray(a, np.float64)
        first, count = get_offsets(a.shape[-1], ngptot, ngptotg or ngptot,
                                   rank, nranks)
        t = torch.as_tensor(a[..., first:first + count]).to(device)
        idx = torch.arange(start, stop, device=t.device) % t.shape[-1]
        out[name] = t.index_select(t.ndim - 1, idx)
    return out
