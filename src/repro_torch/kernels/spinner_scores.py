"""Wrappers of the CSR score kernels (``csrc/spinner_scores.cu``).

``spinner_scores`` computes the dense (V, k) ComputeScores matrix;
``fused_update`` computes the same reduction and the Eq. 7-8 proposal in
one kernel, returning only ``(best, tot_best, tot_cur, m_partial)``;
``fused_update_frontier`` is its frontier variant, which skips the rows
outside a (V,) active mask; ``fused_update_seeded`` is its overlap form,
whose score rows start from a (V, k) interior partial (``acc_init``).  The
base and frontier K1 forms also fold an optional second CSR segment
``delta = (row_ptr, dst, w)``, the session's on-device delta of appended
entries.  Every form gathers neighbour labels from ``lookup`` (default:
``labels``); on a shard of the sharded engine that is the exchange plan's
lookup, while ``labels`` are the rank's own rows.  A tensor on the CPU
goes to the plain version in ``ref``; a CUDA tensor launches the kernel or
raises.  Every wrapper takes ``tile=None`` or a ``(warps, rows)`` pair,
the launch's warps per block and rows per warp group (``None`` in either
place: today's layout, ``scores_layout`` / ``fused_layout``); the plain
versions do not depend on it.  Each wrapper counts
its launches in a plain integer attribute (``spinner_scores.launches``),
raised only where the kernel is launched, so a run can show that it went
through the kernel, and keeps its last launch's ``(warps, rows,
smem_bytes)`` in ``last_tile``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "spinner_scores_csr": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "fused_update_csr": (_I, [_P] * 15 + [_I, _I, _I, ctypes.c_float, _I,
                                          _I, _I, _P]),
    "fused_update_seeded_csr": (_I, [_P] * 13 + [_I, _I, _I, ctypes.c_float,
                                                 _I, _I, _I, _P]),
    "fused_update_frontier_csr": (_I, [_P] * 16 + [_I, _I, ctypes.c_float,
                                                   _I, _I, _I, _P]),
    "spinner_tile_grid": (_I, [_I] * 5),
}
_WARPS = 8                    # warps per block, by default
# The kernels' shared memory, as score_rows / score_warp_bytes and
# fused_rows / fused_smem in spinner_scores.cu reckon it: per warp a fixed
# part and its float buffers of k | 1 floats a row -- K2's score rows, at
# most _SCORE_GROUP_BYTES; K1's score, noise and, in the seeded form, seed
# rows, at most _GROUP_BYTES
_SCORE_GROUP_BYTES = 8448
_SCORE_FIXED_BYTES = 272
_GROUP_BYTES = 12672
_WARP_FIXED_BYTES = 656
MAX_SMEM_BYTES = 232448        # 227 KB, a block's dynamic shared memory


def _check_lookup(lookup, dev) -> None:
    _build.check("lookup", lookup, torch.int32, (lookup.numel(),), dev)


def _check_csr(labels, row_ptr, dst, w, k: int) -> int:
    v = labels.shape[0]
    dev = labels.device
    _build.check("labels", labels, torch.int32, (v,), dev)
    _build.check("row_ptr", row_ptr, torch.int64, (v + 1,), dev)
    _build.check("dst", dst, torch.int32, dst.shape, dev)
    _build.check("w", w, torch.float32, dst.shape, dev)
    if dst.dim() != 1:
        raise ValueError("dst and w must be 1-D")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return v


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


# Each kernel form's shared memory: (buffers of k | 1 floats a row, their
# bytes at most, the warp's fixed part, the block's head at k)
_FORMS = {
    "scores": (1, _SCORE_GROUP_BYTES, _SCORE_FIXED_BYTES, lambda k: 0),
    "fused": (2, _GROUP_BYTES, _WARP_FIXED_BYTES, lambda k: _round16(8 * k)),
    "seeded": (3, _GROUP_BYTES, _WARP_FIXED_BYTES, lambda k: _round16(8 * k)),
}
# spinner_tile_grid's form numbers; the frontier form has the base's layout
_FORM_IDS = {"scores": 0, "fused": 1, "seeded": 2, "frontier": 3}


def _form(form: str) -> tuple:
    if form not in _FORM_IDS:
        raise ValueError(f"unknown kernel form {form!r}; available: "
                         f"{sorted(_FORM_IDS)}")
    return _FORMS["fused" if form == "frontier" else form]


def max_rows(k: int, form: str) -> int:
    """The cap on a ``form`` launch's rows per group at ``k``: as many as
    the group's buffers of ``k | 1`` floats a row hold, 1 to 32."""
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    bufs, group_bytes, _, _ = _form(form)
    return max(1, min(32, group_bytes // (bufs * 4 * (k | 1))))


def _per_warp(k: int, form: str, rows: int) -> int:
    bufs, _, fixed, _ = _form(form)
    return fixed + _round16(bufs * rows * (k | 1) * 4)


def _max_warps(k: int, form: str, rows: int) -> int:
    """The most warps whose groups of ``rows`` rows fit the block."""
    return (MAX_SMEM_BYTES - _form(form)[3](k)) // _per_warp(k, form, rows)


def layout(k: int, form: str, tile=None) -> tuple:
    """``(warps, rows, smem_bytes)`` of a ``form`` launch (``"scores"``:
    K2; ``"fused"`` / ``"frontier"`` / ``"seeded"``: K1's forms) at ``k``.
    Each warp's group holds ``bufs`` buffers of ``rows`` rows of ``k | 1``
    floats after a fixed part; a K1 block adds pen and its M(l) partial.
    ``tile`` is ``(warps, rows)``, either ``None`` for its default: rows
    up to the cap (``max_rows``), and up to 8 warps, as many as fit.
    Raises ``ValueError`` on rows outside [1, cap], fewer than one warp
    or a block above ``MAX_SMEM_BYTES``; the kernel reckons the same rows
    and bytes."""
    cap = max_rows(k, form)
    warps, rows = (None, None) if tile is None else tile
    if rows is None:
        rows = cap
    if not 1 <= rows <= cap:
        raise ValueError(f"rows={rows} outside [1, {cap}] for the {form} "
                         f"kernel at k={k} (at most 32, and as many as its "
                         "shared-memory rows hold)")
    most = _max_warps(k, form, rows)
    if warps is None:
        warps = min(_WARPS, most)
        if warps < 1:
            raise ValueError(f"k={k} is too large for the {form} kernel's "
                             "shared-memory rows")
    elif warps < 1:
        raise ValueError(f"warps={warps}: a launch needs at least one warp")
    smem = _form(form)[3](k) + warps * _per_warp(k, form, rows)
    if warps > most:
        raise ValueError(f"{warps} warps of {rows} rows need {smem} B of "
                         f"shared memory for the {form} kernel at k={k}, "
                         f"above MAX_SMEM_BYTES={MAX_SMEM_BYTES}")
    return warps, rows, smem


def clip_tile(k: int, form: str, tile):
    """``tile`` made valid for a ``form`` launch at ``k``: rows cut to the
    cap, then warps to what the block's shared memory holds (``None``
    stays ``None``, today's layout).  A backend's one tile serves every
    form it launches this way: the seeded form holds fewer rows."""
    if tile is None:
        return None
    warps, rows = tile
    rows = min(max_rows(k, form), rows or 32)
    most = _max_warps(k, form, rows)
    warps = min(most, warps or _WARPS)
    if warps < 1:
        raise ValueError(f"k={k} is too large for the {form} kernel's "
                         "shared-memory rows")
    return warps, rows


def scores_layout(k: int, tile=None) -> tuple:
    """``(warps, rows, smem_bytes)`` of a K2 launch at ``k`` (``layout``):
    by default the rows of each warp's group go up to 32, down to one as k
    grows, and the block fits ``MAX_SMEM_BYTES`` up to k = 58,043."""
    return layout(k, "scores", tile)


def fused_layout(k: int, seeded: bool, tile=None) -> tuple:
    """``(warps, rows, smem_bytes)`` of a K1 launch at ``k``, as
    ``scores_layout``; the block also holds pen and its M(l) partial."""
    return layout(k, "seeded" if seeded else "fused", tile)


def tile_grid(form: str, v: int, k: int, tile=None) -> int:
    """The grid a ``form`` launch over ``v`` rows would take on the
    current card (``csr::grid_for``'s, from the card's occupancy); needs
    the card, launches nothing."""
    warps, rows, _ = layout(k, form, tile)
    lib = _build.load("spinner_scores", _SIGNATURES)
    grid = lib.spinner_tile_grid(_FORM_IDS[form], v, k, warps, rows)
    if grid < 0:
        raise RuntimeError(f"spinner_tile_grid failed with CUDA error "
                           f"{-grid}")
    return grid


def spinner_scores(labels: torch.Tensor, row_ptr: torch.Tensor,
                   dst: torch.Tensor, w: torch.Tensor, k: int,
                   lookup=None, tile=None) -> torch.Tensor:
    """(V, k) f32 scores ``s[v, l] = sum_{e in row v} w[e] [lookup[dst[e]]
    = l]`` over the CSR ``(row_ptr, dst, w)`` of the V rows of ``labels``;
    ``lookup`` holds the neighbours' labels (default ``labels``, as at one
    device; on a shard, the exchange plan's lookup); ``tile`` the launch's
    ``(warps, rows)`` (``scores_layout``)."""
    v = _check_csr(labels, row_ptr, dst, w, k)
    dev = labels.device
    if lookup is None:
        lookup = labels
    _check_lookup(lookup, dev)
    if dev.type == "cpu":
        return ref.spinner_scores_ref(lookup, ref.csr_src(row_ptr), dst, w,
                                      v, k)
    lay = scores_layout(k, tile)
    out = torch.empty((v, k), dtype=torch.float32, device=dev)
    if v == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch("spinner_scores", _SIGNATURES, "spinner_scores_csr",
                      (row_ptr, dst, w, lookup, out), v, k, *lay[:2],
                      stream)
    spinner_scores.launches += 1
    spinner_scores.last_tile = lay
    return out


spinner_scores.launches = 0
spinner_scores.last_tile = None


def _check_propose(labels, row_ptr, dst, w, deg_w, pen, noise, k, delta,
                   lookup) -> tuple:
    """Validate a K1 call; returns ``(v, delta or None, lookup)``."""
    v = _check_csr(labels, row_ptr, dst, w, k)
    dev = labels.device
    _build.check("deg_w", deg_w, torch.float32, (v,), dev)
    _build.check("pen", pen, torch.float32, (k,), dev)
    _build.check("noise", noise, torch.float32, (v, k), dev)
    if lookup is None:
        lookup = labels
    _check_lookup(lookup, dev)
    if not delta:
        return v, None, lookup
    d_row_ptr, d_dst, d_w = delta
    _build.check("delta row_ptr", d_row_ptr, torch.int64, (v + 1,), dev)
    _build.check("delta dst", d_dst, torch.int32, d_dst.shape, dev)
    _build.check("delta w", d_w, torch.float32, d_dst.shape, dev)
    if d_dst.dim() != 1:
        raise ValueError("delta dst and w must be 1-D")
    return v, tuple(delta), lookup


def _check_num_real(num_real: int, v: int) -> None:
    if not 0 <= num_real <= v:
        raise ValueError(f"num_real={num_real} outside [0, {v}]")


def _plain_delta(delta) -> tuple:
    """The delta segment as the plain versions' COO triple."""
    return () if delta is None else (ref.csr_src(delta[0]), *delta[1:])


def _launch_fused(fn, pointers: tuple, v: int, dev, scalars: tuple,
                  k: int, form: str, tile) -> tuple:
    """Allocate K1's outputs and launch wrapper ``fn``'s C entry on the
    card with ``pointers`` (the inputs, in the entry's order) and the
    outputs, at ``tile`` (``layout(k, form, tile)``); counts the launch."""
    lay = layout(k, form, tile)
    best = torch.empty(v, dtype=torch.int32, device=dev)
    tot_best = torch.empty(v, dtype=torch.float32, device=dev)
    tot_cur = torch.empty(v, dtype=torch.float32, device=dev)
    m_partial = torch.zeros(k, dtype=torch.float32, device=dev)
    if v == 0:
        return best, tot_best, tot_cur, m_partial
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch("spinner_scores", _SIGNATURES, f"{fn.__name__}_csr",
                      (*pointers, best, tot_best, tot_cur, m_partial),
                      *scalars, *lay[:2], stream)
    fn.launches += 1
    fn.last_tile = lay
    return best, tot_best, tot_cur, m_partial


def fused_update(labels: torch.Tensor, row_ptr: torch.Tensor,
                 dst: torch.Tensor, w: torch.Tensor, deg_w: torch.Tensor,
                 pen: torch.Tensor, noise: torch.Tensor, num_real: int,
                 k: int, current_bonus: float, degree_weighted: bool,
                 delta: tuple = (), lookup=None, tile=None) -> tuple:
    """The Eq. 7-8 proposal straight from the CSR (see ``ref.propose_ref``).

    ``pen`` is the (k,) penalty ``loads / C``; ``noise`` the (V, k) tie
    noise; vertices ``>= num_real`` are padding, left out of M(l);
    ``delta`` an optional second CSR segment ``(row_ptr, dst, w)`` over
    the same rows; ``lookup`` the neighbours' labels (default ``labels``);
    ``tile`` the launch's ``(warps, rows)`` (``fused_layout``).  Returns ``(best int32 (V,), tot_best f32 (V,), tot_cur f32 (V,),
    m_partial f32 (k,))``; the (V, k) score matrix is never stored.
    """
    v, delta, lookup = _check_propose(labels, row_ptr, dst, w, deg_w, pen,
                                      noise, k, delta, lookup)
    _check_num_real(num_real, v)
    if labels.device.type == "cpu":
        return ref.fused_propose_ref(labels, ref.csr_src(row_ptr), dst, w,
                                     deg_w, pen, noise, num_real, k,
                                     current_bonus, degree_weighted,
                                     _plain_delta(delta), lookup=lookup)
    extra = (None, None, None) if delta is None else delta
    return _launch_fused(fused_update,
                         (row_ptr, dst, w, *extra, labels, lookup, deg_w,
                          pen, noise), v, labels.device,
                         (v, int(num_real), k, float(current_bonus),
                          int(bool(degree_weighted))), k, "fused", tile)


fused_update.launches = 0
fused_update.last_tile = None


def fused_update_seeded(labels: torch.Tensor, row_ptr: torch.Tensor,
                        dst: torch.Tensor, w: torch.Tensor,
                        deg_w: torch.Tensor, pen: torch.Tensor,
                        noise: torch.Tensor, num_real: int, k: int,
                        current_bonus: float, degree_weighted: bool,
                        acc_init: torch.Tensor, lookup=None,
                        tile=None) -> tuple:
    """K1's overlap form (see ``ref.fused_propose_ref`` with ``acc_init``):
    ``fused_update`` whose score rows start from ``acc_init``, the (V, k)
    f32 partial of the shard's interior segment, and fold this CSR's edges
    (the frontier segment, ``dst`` indexing ``lookup``).  Equal bit for bit
    to ``fused_update`` over the interior and frontier edges together
    wherever the weights' sums are exact (the Eq. 3 weights: every partial
    is an exact integer in float32).  ``tile`` as ``fused_update``'s, for
    the seeded layout."""
    v, _, lookup = _check_propose(labels, row_ptr, dst, w, deg_w, pen, noise,
                                  k, (), lookup)
    _check_num_real(num_real, v)
    _build.check("acc_init", acc_init, torch.float32, (v, k), labels.device)
    if labels.device.type == "cpu":
        return ref.fused_propose_ref(labels, ref.csr_src(row_ptr), dst, w,
                                     deg_w, pen, noise, num_real, k,
                                     current_bonus, degree_weighted,
                                     lookup=lookup, acc_init=acc_init)
    return _launch_fused(fused_update_seeded,
                         (row_ptr, dst, w, labels, lookup, acc_init, deg_w,
                          pen, noise), v, labels.device,
                         (v, int(num_real), k, float(current_bonus),
                          int(bool(degree_weighted))), k, "seeded", tile)


fused_update_seeded.launches = 0
fused_update_seeded.last_tile = None


def fused_update_frontier(labels: torch.Tensor, row_ptr: torch.Tensor,
                          dst: torch.Tensor, w: torch.Tensor,
                          deg_w: torch.Tensor, pen: torch.Tensor,
                          noise: torch.Tensor, valid: torch.Tensor, k: int,
                          current_bonus: float, degree_weighted: bool,
                          delta: tuple = (), lookup=None,
                          tile=None) -> tuple:
    """K1's frontier variant (see ``ref.frontier_propose_ref``).

    ``valid`` is the (V,) bool ``real & active`` mask: rows inside it
    propose as ``fused_update`` does, rows outside it skip their edges and
    noise and return ``best = labels``, ``tot_best = tot_cur = 0``; M(l)
    counts only rows inside it.  ``tile`` as ``fused_update``'s.
    """
    v, delta, lookup = _check_propose(labels, row_ptr, dst, w, deg_w, pen,
                                      noise, k, delta, lookup)
    _build.check("valid", valid, torch.bool, (v,), labels.device)
    if labels.device.type == "cpu":
        return ref.frontier_propose_ref(labels, ref.csr_src(row_ptr), dst,
                                        w, deg_w, pen, noise, valid, k,
                                        current_bonus, degree_weighted,
                                        _plain_delta(delta), lookup=lookup)
    extra = (None, None, None) if delta is None else delta
    return _launch_fused(fused_update_frontier,
                         (row_ptr, dst, w, *extra, labels, lookup, deg_w,
                          pen, noise, valid), v, labels.device,
                         (v, k, float(current_bonus),
                          int(bool(degree_weighted))), k, "frontier", tile)


fused_update_frontier.launches = 0
fused_update_frontier.last_tile = None
