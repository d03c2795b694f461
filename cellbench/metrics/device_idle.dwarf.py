"""device_idle.dwarf: the share of a dwarf run in which no device activity
runs on the card, in %: 1 less the traced slice's device-busy time a
run (the union of every kernel, copy and fill, the mean over the
cards) over the median run of the window (CUDA events). The traced
slice, taken after the window, is stretched by the profiler's host cost
and is not used for the length (`loops.Record.idle_share`)."""

LAYER = "device"
MOVES = "dwarf_run_s"


def read(run):
    if run.loop != "dwarf":
        return None
    share = run.idle_share()
    return None if share is None else 100.0 * share
