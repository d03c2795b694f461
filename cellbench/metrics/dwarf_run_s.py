"""dwarf_run_s: the window's host time over the number of complete dwarf
runs in it (each run ends synchronised, in the validation's reduction)."""

LAYER = "end to end"
MOVES = "dwarf_run_s"


def read(run):
    if run.loop != "dwarf":
        return None
    return run.window_s / run.units
