"""Spinner iterations per adapt to the halt (``PartitionResult.
iterations``), averaged over the window's adapts."""
UNIT, LAYER, MOVES = "count", "runner", "adapt_s"


def read(run):
    calls = run.calls("adapt")
    if not calls:
        return None
    return sum(c["iterations"] for c in calls) / len(calls)
