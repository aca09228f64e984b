"""The share of the traced partition call in which no kernel, copy or set
ran on the device (``torch.profiler``).  Percent."""
UNIT, LAYER, MOVES = "%", "device", "partition_s"


def read(run):
    if run.trace is None or run.traffic.kind != "partition":
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
