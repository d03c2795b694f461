"""host_pack_s.dwarf: the harness's span around `CloudscDriver.prepare`
(the host pack: fold, activity sort, grouped expansion), in seconds a
run, the mean over the window's runs."""

LAYER = "driver"
MOVES = "dwarf_run_s"


def read(run):
    spans = run.spans.get("cellbench.prepare")
    if run.loop != "dwarf" or not spans:
        return None
    return sum(spans) / len(spans)
