"""Deterministic tile autotuner for the CSR score kernels (K1 and K2).

The engine binds a ``(warps, rows)`` tile into the CUDA backend
(``core.engine._autotuned``): the warps of a block, and the consecutive
rows of each warp's group (``kernels.spinner_scores.layout``).  The choice
is a pure function of the graph's degree sequence and k -- no timing and
no device query -- so every process picks the same tile for the same
graph, and the pick is memoized per ``(V, E, k, ndev, kernel)``: the
first graph of a session's shape bucket decides, and a warm same-bucket
``adapt()`` keeps the backend it had.

The model follows the kernels' schedule.  Groups are ``rows`` consecutive
rows; group g goes to warp slot ``g % slots`` (the grid-stride loop),
where ``slots = grid * warps`` and the grid is ``csr::grid_for``'s:
enough blocks for every group, at most as many as fit the card at once
(132 SMs; per SM 228 KB of shared memory, 1 KB more a block, 64 warps,
32 blocks, 65,536 registers).  A group costs

    (a + a_smem * f) * batches + b * rows * k / 32 + d * k + c

seconds: ``batches`` are the 128-entry batches its entries fill
(``fold_segment``), ``f`` the share of the SM's 228 KB of shared memory
the launch's resident blocks hold (the SM's 256 KB of L1 and shared
memory are one array, so what the blocks take is no longer cache for the
label gathers), ``rows * k / 32`` the lane steps that zero, copy and (K2)
write its score rows, ``k`` the columns of K1's epilogue (a lane per row
scans all k; 0 for K2), ``c`` its fixed part.  A slot runs its groups
one after another, and its warp waits on its own loads; an SM's warps
also share its issue and memory pipes, so each group costs its SM's
slots as well, ``1 / parallel`` of its cost (a warp's time is its own
latency plus its share of the SM's contention).  A launch then takes

    overhead + max(worst slot + worst SM / parallel, bytes / 3.35 TB/s)

where the bytes are what the launch must move: every input read once,
every output written once.  The constants were fitted on an NVIDIA H100
80GB HBM3 at 700 W by ``chip_smoke.py`` phase (p), which prints the fit
of its own run beside them.  Nothing here is a TPU's.

``_shard_degrees`` counts real entries only (weight > 0): the padded
layout's weight-0 filler rows are streamed but gather no label, so they
cost bytes (``_min_total``), not batches.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .spinner_scores import clip_tile, layout

# (warps, rows) sweep: today's layout (8 warps of 32-row groups, each
# clipped to what k's shared memory holds) first, so a tie keeps it
CANDIDATES = ((8, 32), (8, 16), (8, 8), (4, 32), (4, 16), (4, 8),
              (16, 32), (16, 16), (16, 8))
KERNELS = ("fused", "scores")     # K1's base form, K2

# NVIDIA H100 SXM (NVIDIA's data sheet and Hopper architecture paper)
SMS = 132
SMEM_PER_SM = 233_472            # 228 KB
SMEM_PER_BLOCK_RESERVED = 1024   # what CUDA reserves a block
SMEM_GRANULE = 128
MAX_WARPS_PER_SM = 64
MAX_BLOCKS_PER_SM = 32
REGS_PER_SM = 65_536
REG_GRANULE = 256                # registers are allocated a warp at a time
HBM_BYTES_PER_S = 3.35e12
BATCH = 128                      # fold_segment's entries a batch
# registers a thread (ptxas -v of the sm_90a build, chip_smoke.py (a))
REGISTERS = {"fused": 56, "scores": 48}
# a group's features, in the order of slot_features' columns, and their
# seconds each
FEATURES = ("a", "a_smem", "b", "d", "c")
# per kernel: the FEATURES' seconds, parallel (the SM's contention, see
# above), overhead (seconds a launch): the fit that ``python3
# chip_smoke.py --autotune-only`` printed on an NVIDIA H100 80GB HBM3 at
# 700.00 W over its 54 timed launches a kernel (relative rms error 0.093
# for K1, 0.074 for K2)
COEFFS = {
    "fused": dict(a=1.89678e-06, a_smem=7.95784e-07, b=2.2551e-08,
                  d=4.30834e-08, c=1.63483e-07, parallel=48.0,
                  overhead=2.52939e-05),
    "scores": dict(a=2.14033e-06, a_smem=1.09942e-07, b=4.55838e-08, d=0.0,
                   c=0.0, parallel=64.0, overhead=1.10188e-05),
}

_CHOICE_CACHE: dict = {}


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; available: "
                         f"{', '.join(KERNELS)}")


def candidates(k: int, kernel: str = "fused") -> list:
    """``CANDIDATES`` clipped to what ``kernel``'s shared memory holds at
    k (``spinner_scores.clip_tile``), duplicates dropped, order kept."""
    _check_kernel(kernel)
    out = []
    for tile in CANDIDATES:
        t = clip_tile(k, kernel, tile)
        if t not in out:
            out.append(t)
    return out


def blocks_per_sm(kernel: str, warps: int, smem: int) -> int:
    """Blocks of ``warps`` warps and ``smem`` dynamic bytes an SM holds at
    once, as the card's occupancy query reckons it (at least 1)."""
    per_warp_regs = round_up(REGISTERS[kernel] * 32, REG_GRANULE)
    by_regs = (REGS_PER_SM // per_warp_regs) // warps
    by_smem = SMEM_PER_SM // (round_up(smem, SMEM_GRANULE)
                              + SMEM_PER_BLOCK_RESERVED)
    return max(1, min(MAX_BLOCKS_PER_SM, MAX_WARPS_PER_SM // warps, by_regs,
                      by_smem))


def _launch_bytes(v: int, entries: int, k: int, kernel: str) -> float:
    """Bytes a launch over v rows and ``entries`` entries must move."""
    csr = (v + 1) * 8 + entries * 8 + v * 4       # row_ptr, dst + w, labels
    if kernel == "scores":
        return float(csr + v * k * 4)             # the score matrix
    # deg, noise; best, tot_best, tot_cur; pen and M(l)
    return float(csr + v * 4 + v * k * 4 + 3 * v * 4 + 2 * k * 4)


def _sum_by(index: np.ndarray, rows: np.ndarray, n: int) -> np.ndarray:
    return np.stack([np.bincount(index, weights=rows[:, j], minlength=n)
                     for j in range(rows.shape[1])], axis=1)


def slot_features(deg: np.ndarray, warps: int, rows: int, k: int,
                  kernel: str = "fused") -> dict:
    """The schedule of one launch over rows of degrees ``deg``: the
    per-slot and per-SM sums of each group's ``FEATURES`` (batches,
    batches times the resident blocks' share of the SM's shared memory,
    ``rows * k / 32``, epilogue columns, 1; the model's cost is their dot
    product with the coefficients), and the grid, groups and largest
    group."""
    v = int(deg.shape[0])
    _, _, smem = layout(k, kernel, (warps, rows))
    if v == 0:
        zero = np.zeros((1, len(FEATURES)))
        return dict(slots=zero, sms=zero, grid=0, groups=0,
                    max_group_entries=0, smem_bytes=smem)
    groups = -(-v // rows)
    starts = np.arange(0, v, rows)
    entries = np.add.reduceat(deg.astype(np.int64), starts)
    n = np.minimum(rows, v - starts)
    per_sm = blocks_per_sm(kernel, warps, smem)
    grid = min(-(-groups // warps), SMS * per_sm)
    share = min(per_sm, -(-grid // SMS)) * (
        round_up(smem, SMEM_GRANULE) + SMEM_PER_BLOCK_RESERVED) / SMEM_PER_SM
    slots = grid * warps
    batches = -(-entries // BATCH)
    feats = np.stack([batches, batches * share,
                      n * k / 32.0,
                      np.full(groups, float(k if kernel == "fused" else 0)),
                      np.ones(groups)], axis=1).astype(np.float64)
    per_slot = _sum_by(np.arange(groups) % slots, feats, slots)
    # blocks go to the SMs in turn
    per_sm = _sum_by((np.arange(slots) // warps) % SMS, per_slot, SMS)
    return dict(slots=per_slot, sms=per_sm, grid=grid, groups=groups,
                max_group_entries=int(entries.max()), smem_bytes=smem)


def _shard_cost(deg: np.ndarray, warps: int, rows: int, k: int,
                kernel: str = "fused", min_total: int = 0) -> dict:
    """Modeled seconds of one launch (``cost_s``) with its schedule."""
    f = slot_features(deg, warps, rows, k, kernel)
    co = COEFFS[kernel]
    x = np.array([co[name] for name in FEATURES])
    nbytes = _launch_bytes(int(deg.shape[0]),
                           max(int(deg.sum()), int(min_total)), k, kernel)
    cost = co["overhead"] + max(
        float((f["slots"] @ x).max())
        + float((f["sms"] @ x).max()) / co["parallel"],
        nbytes / HBM_BYTES_PER_S)
    return dict(f, cost_s=cost, bytes=nbytes)


def _shard_degrees(graph, ndev: int) -> list:
    """Per-shard REAL entry counts of each row (weight-0 filler gathers
    nothing); shards are ``ceil(V / ndev)`` consecutive rows."""
    deg = np.diff(np.asarray(graph.row_ptr)).astype(np.int64)
    w = np.asarray(graph.weight)
    zero = w == 0
    if zero.any():
        deg -= np.bincount(np.asarray(graph.src)[zero],
                           minlength=graph.num_vertices)
    if ndev <= 1:
        return [deg]
    v_local = -(-deg.shape[0] // ndev)
    return [deg[p * v_local:(p + 1) * v_local] for p in range(ndev)]


def _min_total(graph, ndev: int) -> int:
    # one device streams every padded entry, filler too; a shard's own
    # filler is charged with its rows' real entries only
    return int(np.asarray(graph.src).shape[0]) if ndev <= 1 else 0


def sweep(graph, k: int, ndev: int = 1, kernel: str = "fused") -> list:
    """Every candidate's modeled launch (the max over shards): one row per
    ``candidates(k, kernel)`` tile with ``warps``, ``rows``,
    ``smem_bytes``, ``grid``, ``groups``, ``max_group_entries`` and
    ``cost_s`` (the largest shard's schedule)."""
    shards = _shard_degrees(graph, ndev)
    min_total = _min_total(graph, ndev)
    out = []
    for warps, rows in candidates(k, kernel):
        per = [_shard_cost(d, warps, rows, k, kernel, min_total)
               for d in shards]
        worst = max(per, key=lambda r: r["cost_s"])
        out.append({"warps": warps, "rows": rows,
                    "smem_bytes": worst["smem_bytes"], "grid": worst["grid"],
                    "groups": worst["groups"],
                    "max_group_entries": worst["max_group_entries"],
                    "cost_s": worst["cost_s"]})
    return out


def choose_tile_config(graph, k: int, ndev: int = 1, kernel: str = "fused"
                       ) -> Tuple[int, int, int]:
    """``(warps, rows, smem_bytes)`` minimizing the modeled launch time.

    Deterministic: strict ``<`` with ties broken in ``CANDIDATES`` order
    (today's layout first), memoized on the graph's ``(V, E, k, ndev,
    kernel)``."""
    _check_kernel(kernel)
    key = (int(graph.num_vertices), int(np.asarray(graph.src).shape[0]),
           int(k), int(ndev), kernel)
    hit = _CHOICE_CACHE.get(key)
    if hit is not None:
        return hit
    best, best_cost = None, float("inf")
    for row in sweep(graph, k, ndev, kernel):
        if row["cost_s"] < best_cost:
            best, best_cost = row, row["cost_s"]
    choice = (best["warps"], best["rows"], best["smem_bytes"])
    _CHOICE_CACHE[key] = choice
    return choice


def modeled_traffic(padded_v: int, e_pad: int, k: int
                    ) -> Tuple[dict, dict]:
    """(split, fused) per-iteration device-memory byte models of the two
    routes.  The split route's K2 writes the (V, k) score matrix and the
    epilogue reads it back; the fused K1 keeps each score row in shared
    memory, so exactly those two V*k terms go.  Both stream the CSR
    (int64 row pointers, int32 dst, float32 w) and the labels, and the
    tie noise is charged alike (written at the draw, read at use)."""
    vk = padded_v * k * 4.0
    csr = (padded_v + 1) * 8.0 + e_pad * 8.0
    split = {"csr": csr, "labels": padded_v * 4.0, "noise": 2.0 * vk,
             "score_write": vk, "score_read": vk}
    fused = {"csr": csr, "labels": padded_v * 4.0, "noise": 2.0 * vk}
    return split, fused

