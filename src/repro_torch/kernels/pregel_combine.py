"""Wrappers of the Pregel combine kernels (``csrc/pregel_combine.cu``).

``pregel_reduce`` folds each CSR row's gathered messages into a (rows,)
partial -- the interior half of a superstep; ``pregel_combine`` does the
same fold seeded by that partial and applies the vertex update in the
same kernel -- the frontier half.  Both take ``send`` in vertex order and
gather ``send[dst]`` themselves, and read the CSR as it is: it holds no
pad slots, so there is no weight mask.

A tensor on the CPU goes to the plain version in ``ref``; a CUDA tensor
launches the kernel or raises.  Each wrapper counts its launches in a
plain integer attribute (``pregel_reduce.launches``), raised only where
the kernel is launched.  The sum (PageRank) runs in float32 without
atomics, so a launch's bits repeat run to run; the min (int32) is
bit-exact.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import _build, ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_REDUCE = (_I, [_P, _P, _P, _P, _P, _I, _I, _P])
_COMBINE = (_I, [_P] * 8 + [_I, _I, _F, _F, _P])
_SIGNATURES = {"pregel_reduce_sum_csr": _REDUCE,
               "pregel_reduce_min_csr": _REDUCE,
               "pregel_combine_sum_csr": _COMBINE,
               "pregel_combine_min_csr": _COMBINE}
_DTYPES = {"sum": torch.float32, "min": torch.int32}
_UPDATES = {"sum": "pagerank", "min": "min"}


def _check_args(send, row_ptr, dst, combine: str, bias: int,
                acc_init) -> int:
    """Validate the reduce's inputs; returns the row count."""
    if combine not in _DTYPES:
        raise ValueError(f"unknown combine {combine!r}; available: sum, min")
    if combine == "sum" and bias:
        raise ValueError("sum messages take no bias")
    dev = send.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    rows = row_ptr.shape[0] - 1
    if send.dim() != 1 or dst.dim() != 1 or rows < 0:
        raise ValueError("send, row_ptr and dst must be 1-D")
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed the kernels' int32 row index")
    _build.check("send", send, _DTYPES[combine], send.shape, dev)
    _build.check("row_ptr", row_ptr, torch.int64, (rows + 1,), dev)
    _build.check("dst", dst, torch.int32, dst.shape, dev)
    if acc_init is not None:
        _build.check("acc_init", acc_init, _DTYPES[combine], (rows,), dev)
    return rows


def pregel_reduce(send: torch.Tensor, row_ptr: torch.Tensor,
                  dst: torch.Tensor, *, combine: str, bias: int = 0,
                  acc_init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(rows,) partial: per row v, the ``combine`` ("sum" float32 or "min"
    int32) of ``send[dst[e]] + bias`` over v's edges, seeded by
    ``acc_init[v]`` (see ``ref.pregel_reduce_ref``).  ``dst`` must index
    into ``send``; the layout that builds the CSR guarantees it."""
    rows = _check_args(send, row_ptr, dst, combine, bias, acc_init)
    dev = send.device
    if dev.type == "cpu":
        return ref.pregel_reduce_ref(send, row_ptr, dst, combine=combine,
                                     bias=bias, acc_init=acc_init)
    out = torch.empty(rows, dtype=_DTYPES[combine], device=dev)
    if rows == 0:
        return out
    with torch.cuda.device(dev):
        _build.launch("pregel_combine", _SIGNATURES,
                      f"pregel_reduce_{combine}_csr",
                      (row_ptr, dst, send, acc_init, out), rows, int(bias),
                      torch.cuda.current_stream(dev).cuda_stream)
    pregel_reduce.launches += 1
    return out


pregel_reduce.launches = 0


def pregel_combine(send: torch.Tensor, row_ptr: torch.Tensor,
                   dst: torch.Tensor, values: torch.Tensor,
                   valid: torch.Tensor, base: float, *, combine: str,
                   update: str, damping: float, bias: int = 0,
                   acc_init: Optional[torch.Tensor] = None) -> tuple:
    """The reduce seeded by ``acc_init``, then the vertex update (see
    ``ref.pregel_combine_ref``); returns ``(new, chg bool)``, (rows,)
    each.  ``base`` must be a float32 value (PageRank's ``(1 - d) / N``,
    computed in double and cast once); ``damping`` is used as float32."""
    rows = _check_args(send, row_ptr, dst, combine, bias, acc_init)
    if update != _UPDATES[combine]:
        raise ValueError(f"combine {combine!r} takes no update {update!r}: "
                         "pair sum with pagerank, min with min")
    if float(np.float32(base)) != float(base):
        raise ValueError(f"base {base!r} is not a float32 value")
    dev = send.device
    _build.check("values", values, _DTYPES[combine], (rows,), dev)
    _build.check("valid", valid, torch.bool, (rows,), dev)
    if dev.type == "cpu":
        return ref.pregel_combine_ref(send, row_ptr, dst, values, valid,
                                      base, combine=combine, update=update,
                                      damping=damping, bias=bias,
                                      acc_init=acc_init)
    new = torch.empty(rows, dtype=_DTYPES[combine], device=dev)
    chg = torch.empty(rows, dtype=torch.bool, device=dev)
    if rows == 0:
        return new, chg
    with torch.cuda.device(dev):
        _build.launch("pregel_combine", _SIGNATURES,
                      f"pregel_combine_{combine}_csr",
                      (row_ptr, dst, send, values, valid, acc_init, new, chg),
                      rows, int(bias), float(base), float(damping),
                      torch.cuda.current_stream(dev).cuda_stream)
    pregel_combine.launches += 1
    return new, chg


pregel_combine.launches = 0
