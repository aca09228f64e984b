"""Bytes the delta fast path uploads per batch: the session's
``stats()["delta"]["last_upload_bytes"]`` after each of the window's
adapts, averaged."""
UNIT, LAYER, MOVES = "B", "delta merge", "adapt_s"


def read(run):
    calls = run.calls("adapt")
    if not calls:
        return None
    return sum(c["upload_bytes"] for c in calls) / len(calls)
