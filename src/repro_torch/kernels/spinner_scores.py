"""Wrappers of the CSR score kernels (``csrc/spinner_scores.cu``).

``spinner_scores`` computes the dense (V, k) ComputeScores matrix;
``fused_update`` computes the same reduction and the Eq. 7-8 proposal in
one kernel, returning only ``(best, tot_best, tot_cur, m_partial)``.  A
tensor on the CPU goes to the plain version in ``ref``; a CUDA tensor
launches the kernel or raises.  Each wrapper counts its launches in a
plain integer attribute (``spinner_scores.launches``), raised only where
the kernel is launched, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "spinner_scores_csr": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "fused_update_csr": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, ctypes.c_float, _I, _I, _P]),
}
_WARPS = 8                    # warps (vertex rows in flight) per block
_SMEM_FLOATS = 48 * 1024 // 4  # static-launch shared memory limit


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_csr(labels, row_ptr, dst, w, k: int) -> int:
    v = labels.shape[0]
    dev = labels.device
    _check("labels", labels, torch.int32, (v,), dev)
    _check("row_ptr", row_ptr, torch.int64, (v + 1,), dev)
    _check("dst", dst, torch.int32, dst.shape, dev)
    _check("w", w, torch.float32, dst.shape, dev)
    if dst.dim() != 1:
        raise ValueError("dst and w must be 1-D")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return v


def _warps(k: int, extra_rows: int) -> int:
    """Warps per block whose score rows (plus ``extra_rows`` block-wide
    k-vectors) fit the static shared-memory limit."""
    warps = min(_WARPS, _SMEM_FLOATS // k - extra_rows)
    if warps < 1:
        raise ValueError(f"k={k} is too large for the CSR kernels' "
                         "shared-memory score rows")
    return warps


def _launch(fn: str, tensors, *scalars) -> None:
    """Call C entry ``fn`` with the tensors' device pointers, then the
    scalars (the stream last); raise on the CUDA error it returns."""
    lib = _build.load("spinner_scores", _SIGNATURES)
    err = getattr(lib, fn)(*(t.data_ptr() for t in tensors), *scalars)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed with CUDA error {err}")


def spinner_scores(labels: torch.Tensor, row_ptr: torch.Tensor,
                   dst: torch.Tensor, w: torch.Tensor,
                   k: int) -> torch.Tensor:
    """(V, k) f32 scores ``s[v, l] = sum_{u in N(v)} w(v, u) [labels[u] = l]``
    over the CSR ``(row_ptr, dst, w)``."""
    v = _check_csr(labels, row_ptr, dst, w, k)
    if labels.device.type == "cpu":
        return ref.spinner_scores_ref(labels, ref.csr_src(row_ptr), dst, w,
                                      v, k)
    warps = _warps(k, 0)
    out = torch.empty((v, k), dtype=torch.float32, device=labels.device)
    if v == 0:
        return out
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream(labels.device).cuda_stream
        _launch("spinner_scores_csr", (row_ptr, dst, w, labels, out), v, k,
                warps, stream)
    spinner_scores.launches += 1
    return out


spinner_scores.launches = 0


def fused_update(labels: torch.Tensor, row_ptr: torch.Tensor,
                 dst: torch.Tensor, w: torch.Tensor, deg_w: torch.Tensor,
                 pen: torch.Tensor, noise: torch.Tensor, num_real: int,
                 k: int, current_bonus: float,
                 degree_weighted: bool) -> tuple:
    """The Eq. 7-8 proposal straight from the CSR (see ``ref.propose_ref``).

    ``pen`` is the (k,) penalty ``loads / C``; ``noise`` the (V, k) tie
    noise; vertices ``>= num_real`` are padding, left out of M(l).
    Returns ``(best int32 (V,), tot_best f32 (V,), tot_cur f32 (V,),
    m_partial f32 (k,))``; the (V, k) score matrix is never stored.
    """
    v = _check_csr(labels, row_ptr, dst, w, k)
    dev = labels.device
    _check("deg_w", deg_w, torch.float32, (v,), dev)
    _check("pen", pen, torch.float32, (k,), dev)
    _check("noise", noise, torch.float32, (v, k), dev)
    if not 0 <= num_real <= v:
        raise ValueError(f"num_real={num_real} outside [0, {v}]")
    if dev.type == "cpu":
        return ref.fused_propose_ref(labels, ref.csr_src(row_ptr), dst, w,
                                     deg_w, pen, noise, num_real, k,
                                     current_bonus, degree_weighted)
    warps = _warps(k, 1)
    best = torch.empty(v, dtype=torch.int32, device=dev)
    tot_best = torch.empty(v, dtype=torch.float32, device=dev)
    tot_cur = torch.empty(v, dtype=torch.float32, device=dev)
    m_partial = torch.zeros(k, dtype=torch.float32, device=dev)
    if v == 0:
        return best, tot_best, tot_cur, m_partial
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("fused_update_csr",
                (row_ptr, dst, w, labels, deg_w, pen, noise, best, tot_best,
                 tot_cur, m_partial),
                v, int(num_real), k, float(current_bonus),
                int(bool(degree_weighted)), warps, stream)
    fused_update.launches += 1
    return best, tot_best, tot_cur, m_partial


fused_update.launches = 0
