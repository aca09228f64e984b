"""Peaks of the card and the bytes each hand-written kernel must move.

The peaks are NVIDIA's published figures for one H100 SXM at its full
700 W power limit (the data sheet, dense rates).  The byte counts are the
least traffic of one launch: every input read once and every output
written once, whatever the kernel reads again.  They count the PADDED
layout the kernels run on (``V_pad`` rows, ``E_pad`` entries, the pad
entries being weight-0 self-loops), because that is what a launch reads;
a count over the real graph alone would be smaller by the padding
(under 25%).  Copied from ``chip_smoke.py`` (its lines cited), so that
the yardstick lives with the benchmark.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
BF16_FLOPS = 989e12              # dense bf16 tensor cores


def csr_bytes(v: int, e: int) -> int:
    """row_ptr (int64, v + 1), dst (int32) and w (float32) per entry, and
    one (v,) int32 vector (``chip_smoke.py:401``)."""
    return (v + 1) * 8 + e * 4 + e * 4 + v * 4


def k1_bytes(v: int, e: int, k: int) -> int:
    """K1, ``fused_update_csr``: the CSR, labels, pen (k), the (v, k)
    noise in; best, tot_best, tot_cur and M(l) out
    (``chip_smoke.py:403``)."""
    return csr_bytes(v, e) + v * 4 + k * 4 + v * k * 4 + 3 * v * 4 + k * 4


def k2_bytes(v: int, e: int, k: int) -> int:
    """K2, ``spinner_scores_csr``: the CSR in, the (v, k) float32 score
    matrix out (``chip_smoke.py:402``)."""
    return csr_bytes(v, e) + v * k * 4


def pregel_bytes(rows: int, edges: int, combine: str, seeded: bool = False,
                 update: bool = False) -> int:
    """K3 (``update=False``) and K4 (``update=True``), the Pregel combine:
    row_ptr, dst, the (rows,) output, the seed partial if ``seeded``, for
    the update the valid mask, the changed flags and (min) the values, and
    the send vector once when there are edges (``chip_smoke.py:620-638``,
    ``pregel_bound``)."""
    nbytes = (rows + 1) * 8 + edges * 4 + rows * 4
    if seeded:
        nbytes += rows * 4
    if update:
        nbytes += rows + rows + (rows * 4 if combine == "min" else 0)
    return nbytes + (rows * 4 if edges else 0)


def bound_s(nbytes: int) -> float:
    """The least time to move ``nbytes`` at the HBM rate."""
    return nbytes / HBM_BYTES_PER_S
