"""h2d_s.dwarf: `Timings.h2d_s` as `CloudscDriver.run` returns it (host
clock around `shard` and a sync), the mean over the window's runs."""

LAYER = "driver"
MOVES = "dwarf_run_s"


def read(run):
    if run.loop != "dwarf" or not run.h2d_s:
        return None
    return sum(run.h2d_s) / len(run.h2d_s)
