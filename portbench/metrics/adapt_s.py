"""Time to re-converge after one batch of new edges: the summed wall time
of the window's ``adapt(edge_updates=...)`` calls, from the batch handed
in to the labels on the host, over their number.  Host clock."""
UNIT, LAYER, MOVES = "s", "end to end", "adapt_s"


def read(run):
    calls = run.calls("adapt")
    if not calls:
        return None
    return sum(c["seconds"] for c in calls) / len(calls)
