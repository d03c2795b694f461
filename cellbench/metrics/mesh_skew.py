"""mesh_skew: the device time of the busiest card over the cards' mean,
minus 1, in %, from the traced slice: how far one card's share of the
columns costs more than the others' (a coupled model waits for it)."""

LAYER = "mesh"
MOVES = "columns_per_s"


def read(run):
    if run.chips < 2 or run.slice is None or run.slice.mean_device_s <= 0:
        return None
    return 100.0 * (max(run.slice.device_s) / run.slice.mean_device_s - 1.0)
