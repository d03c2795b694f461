"""kernel_roofline.fp32: `kernel_roofline` in the fp32 cells, which report
`columns_per_s.fp32`; read as `kernel_roofline` reads it."""

from cellbench import work

LAYER = "kernels"
MOVES = "columns_per_s.fp32"


def read(run):
    if run.loop != "resident" or run.slice is None \
            or run.slice.mean_device_s <= 0:
        return None
    least, _ = work.least_time_s(run.columns_per_chip, run.levels,
                                 run.precision)
    return 100.0 * least * run.slice.units / run.slice.mean_device_s
