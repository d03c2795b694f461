"""setup_s: seconds from the process's start to the first timed unit:
imports, loading K1 from the build cache (building it on a checkout's first
run), making the inputs, H2D and the warm-up; the harness's reference work
is left out."""

LAYER = "end to end"
MOVES = "setup_s"


def read(run):
    return run.setup_s
