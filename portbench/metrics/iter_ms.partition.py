"""Milliseconds per Spinner iteration in the window's partitions: their
wall time over their iterations (``PartitionResult.iterations``)."""
UNIT, LAYER, MOVES = "ms", "runner", "partition_s"


def read(run):
    calls = run.calls("partition")
    iters = sum(c["iterations"] for c in calls)
    if not iters:
        return None
    return 1e3 * sum(c["seconds"] for c in calls) / iters
