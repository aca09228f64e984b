"""The runner's Eq. 11-12 epilogue per iteration in the traced partitions:
the device time of the program's ``runner.epilogue`` spans (the stream
time between their CUDA events, ``repro_torch.runtime.trace``) under the
traced calls' ``session.partition`` roots, over those calls' iterations.
Nothing without the program's tracer, or on the CPU."""
UNIT, LAYER, MOVES = "ms", "runner", "partition_s"
ROOT, SPAN = "session.partition", "runner.epilogue"


def read(run):
    if not run.traced:
        return None
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    recs = trace.records()
    calls = {r.call for r in recs
             if r.name == ROOT and r.parent is None}
    calls = set(sorted(calls)[-len(run.traced):])
    device = [r.device_ms for r in recs if r.name == SPAN and r.call in calls]
    iters = sum(c["iterations"] for c in run.traced)
    if not device or None in device or not iters:
        return None
    return sum(device) / iters
