"""The share of the traced adapt calls in which no kernel, copy or set ran
on the device (``torch.profiler``).  Percent."""
UNIT, LAYER, MOVES = "%", "device", "adapt_s"


def read(run):
    if run.trace is None or run.traffic.kind != "adapt":
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
