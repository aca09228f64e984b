"""The runner's random draws per iteration in the traced partition: the
device time of the work launched while the program is inside its threefry
draws (``repro_torch.rng.uniform``, spanned ``draws`` by
``harness/trace.py``), over the traced calls' iterations.  Nothing when
the runner draws elsewhere."""
UNIT, LAYER, MOVES = "ms", "draws", "partition_s"


def read(run):
    if run.trace is None or run.traffic.kind != "partition":
        return None
    seconds = run.trace["span_device_s"].get("draws", 0.0)
    iters = sum(c["iterations"] for c in run.traced)
    if not seconds or not iters:
        return None
    return 1e3 * seconds / iters
