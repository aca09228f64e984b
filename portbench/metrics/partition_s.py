"""Time to partition from scratch to the halt: the summed wall time of the
window's whole ``partition()`` calls over their number.  Host clock, each
call ending in a device synchronisation."""
UNIT, LAYER, MOVES = "s", "end to end", "partition_s"


def read(run):
    calls = run.calls("partition")
    if not calls:
        return None
    return sum(c["seconds"] for c in calls) / len(calls)
