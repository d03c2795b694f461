"""kernel_roofline: the least time of one step (cellbench/work.py: the
larger of the counted bytes over the HBM peak and the counted operations
over the precision's peak, for one card's share) over the device time of
all device activity of a step (every kernel, copy and fill in the traced
slice, summed, over the steps traced; on a mesh the mean over the cards),
in %."""

from cellbench import work

LAYER = "kernels"
MOVES = "columns_per_s"


def read(run):
    if run.loop != "resident" or run.slice is None \
            or run.slice.mean_device_s <= 0:
        return None
    least, _ = work.least_time_s(run.columns_per_chip, run.levels,
                                 run.precision)
    return 100.0 * least * run.slice.units / run.slice.mean_device_s
