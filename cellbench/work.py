"""The work of one CLOUDSC step and the card's published peaks: the
yardstick that `kernel_roofline` holds the device time to.

The count depends on the columns, the levels and the precision alone, never
on the form the program streams (folded or unfolded pack, field dict) or on
its kernels: (a) each input field the reference configuration's scheme
reads, read once; (b) each of the 21 outputs, written once at working
precision; (c) operations by the reference's flop model (dwarf-p-cloudsc
timer_mod.F90: 12,482,329 flop per 100 columns at 137 levels, scaled by the
levels). The aerosol fields are read only under an aerosol coupling, which
no configuration here turns on.

Peaks: NVIDIA's data sheet for one H100 SXM at 700 W, HBM 3.35 TB/s and the
non-tensor-core rates 67 TFLOP/s in fp32, 34 TFLOP/s in fp64.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "fp64": 34e12}
WORD_BYTES = {"fp32": 4, "fp64": 8}
FLAG_BYTES = 4   # LOGICAL and INTEGER(JPIM) of the dwarf: LDCUM, KTYPE

# the reference's flop model: a column over its 137 levels
FLOP_PER_COLUMN = 12482329 / 100
FLOP_LEVELS = 137

# (a) the inputs the scheme reads: full-level fields (PCLV and
# TENDENCY_TMP_CLD count their four condensate species), the half-level
# pressure, the per-column fields at working precision and the two flags
LEVEL_INPUTS = (
    "PT", "PQ", "PA", "TENDENCY_TMP_T", "TENDENCY_TMP_Q", "TENDENCY_TMP_A",
    "PAP", "PVERVEL", "PHRSW", "PHRLW", "PMFU", "PMFD", "PLU", "PLUDE",
    "PSNDE", "PSUPSAT", "PVFL", "PVFI",
    "PCLV[0]", "PCLV[1]", "PCLV[2]", "PCLV[3]",
    "TENDENCY_TMP_CLD[0]", "TENDENCY_TMP_CLD[1]", "TENDENCY_TMP_CLD[2]",
    "TENDENCY_TMP_CLD[3]",
)
HALF_INPUTS = ("PAPH",)
COLUMN_INPUTS = ("PLSM",)
FLAG_INPUTS = ("LDCUM", "KTYPE")

# (b) the 21 outputs: full-level rows (TENDENCY_LOC_CLD has five species),
# half-level fluxes, one per-column field
LEVEL_OUTPUTS = (
    "PLUDE", "PCOVPTOT", "TENDENCY_LOC_T", "TENDENCY_LOC_Q",
    "TENDENCY_LOC_A", "TENDENCY_LOC_CLD[0]", "TENDENCY_LOC_CLD[1]",
    "TENDENCY_LOC_CLD[2]", "TENDENCY_LOC_CLD[3]", "TENDENCY_LOC_CLD[4]",
)
HALF_OUTPUTS = (
    "PFSQLF", "PFSQIF", "PFCQLNG", "PFCQNNG", "PFSQRF", "PFSQSF",
    "PFCQRNG", "PFCQSNG", "PFSQLTUR", "PFSQITUR", "PFPLSL", "PFPLSN",
    "PFHPSL", "PFHPSN",
)
COLUMN_OUTPUTS = ("PRAINFRAC_TOPRFZ",)


def field_table(nlev: int, precision: str) -> list[tuple[str, str, int]]:
    """(field, "in" or "out", bytes a column) for every counted field."""
    w = WORD_BYTES[precision]
    rows = [(n, "in", nlev * w) for n in LEVEL_INPUTS]
    rows += [(n, "in", (nlev + 1) * w) for n in HALF_INPUTS]
    rows += [(n, "in", w) for n in COLUMN_INPUTS]
    rows += [(n, "in", FLAG_BYTES) for n in FLAG_INPUTS]
    rows += [(n, "out", nlev * w) for n in LEVEL_OUTPUTS]
    rows += [(n, "out", (nlev + 1) * w) for n in HALF_OUTPUTS]
    rows += [(n, "out", w) for n in COLUMN_OUTPUTS]
    return rows


def input_bytes(ncol: int, nlev: int, precision: str) -> int:
    return ncol * sum(b for _, d, b in field_table(nlev, precision)
                      if d == "in")


def step_bytes(ncol: int, nlev: int, precision: str) -> int:
    """Bytes one step must move: inputs read once, outputs written once."""
    return ncol * sum(b for _, _, b in field_table(nlev, precision))


def step_flops(ncol: int, nlev: int) -> float:
    return FLOP_PER_COLUMN * ncol * nlev / FLOP_LEVELS


def least_time_s(ncol: int, nlev: int, precision: str) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time one card could
    take for a step over `ncol` columns, the larger of the bytes over the
    HBM peak and the operations over the precision's peak."""
    t_bytes = step_bytes(ncol, nlev, precision) / PEAK_BYTES_PER_S
    t_ops = step_flops(ncol, nlev) / PEAK_FLOPS[precision]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
