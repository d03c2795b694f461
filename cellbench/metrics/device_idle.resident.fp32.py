"""device_idle.resident.fp32: `device_idle.resident` in the fp32 cells,
which report `columns_per_s.fp32`; read as `device_idle.resident` reads
it."""

LAYER = "device"
MOVES = "columns_per_s.fp32"


def read(run):
    if run.loop != "resident":
        return None
    share = run.idle_share()
    return None if share is None else 100.0 * share
