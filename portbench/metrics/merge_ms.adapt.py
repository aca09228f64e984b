"""The batch's upload and on-device merge per traced adapt: the host time
of the program's ``delta.merge`` spans (``delta.apply_batch``,
``repro_torch.runtime.trace``) under the traced calls' ``session.adapt``
roots, over their number.  Nothing without the program's tracer."""
UNIT, LAYER, MOVES = "ms", "delta merge", "adapt_s"
ROOT, SPAN = "session.adapt", "delta.merge"


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
    host = [r.host_ms for r in recs if r.name == SPAN and r.call in calls]
    if not host:
        return None
    return sum(host) / len(calls)
