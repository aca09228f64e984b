"""K1 (``fused_update_csr``, kernel ``fused_update_kernel``) against its
roofline: the least time to move the bytes one launch must move at the
cell's padded shapes (``portbench.roofline.k1_bytes``) at 3.35 TB/s, over
its mean device time per launch in the traced partition.  Percent."""
from portbench import roofline

UNIT, LAYER, MOVES = "%", "kernels", "partition_s"
KERNEL = "fused_update_kernel"


def read(run):
    if run.trace is None or run.traffic.kind != "partition":
        return None
    hits = [v for name, v in run.trace["kernels"].items() if KERNEL in name]
    launches = sum(n for _, n in hits)
    if not launches:
        return None
    per_launch = sum(s for s, _ in hits) / launches
    v_pad, e_pad = run.padded_shape
    k = int(run.config["spinner"]["k"])
    return 100.0 * roofline.bound_s(roofline.k1_bytes(v_pad, e_pad, k)) \
        / per_launch
