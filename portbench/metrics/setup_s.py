"""Set-up time: process start to the first timed call (graph made on the
device, the program's session opened, its shapes warmed; in a run that
builds the kernels, their build too).  Host clock."""
UNIT, LAYER, MOVES = "s", "end to end", "setup_s"


def read(run):
    return run.setup_s
