"""Wrapper of the threefry uniform kernel (``csrc/threefry.cu``).

``uniform_threefry`` draws ``rng.uniform``'s float32 values for one key
or for many in one launch: the threefry2x32 bits of each counter, the
mantissa trick and the scale and shift, in registers, with only the
output written.  It is the card's half of ``rng.uniform`` and
``rng.uniform_many``, whose plain versions (``rng._uniform_plain``,
``rng._uniform_many_plain``) compute the same bits from int64 PyTorch ops
and serve the CPU.  It takes CUDA tensors only and raises on anything
else; it counts its launches in a plain integer attribute
(``uniform_threefry.launches``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U, _F = ctypes.c_uint, ctypes.c_float
_SIGNATURES = {
    "threefry_uniform": (_I, [_P, _P, _LL, _LL, _U, _U, _I, _LL, _LL, _F,
                              _F, _P]),
}
_M32 = 0xFFFFFFFF


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"uniform_threefry runs on a CUDA device, got "
                         f"{dev}; the CPU takes rng's plain version")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def uniform_threefry(keys, n: int, lo: float, span: float, *, device,
                     offset: int = 0) -> torch.Tensor:
    """Uniform float32 draws at the flat counters ``offset + i``, ``i`` in
    ``[0, n)``: ``max(f * span + lo, lo)`` rounded after the product and
    after the sum, ``f`` in [0, 1) from the 23 high bits of ``y0 ^ y1``,
    ``(y0, y1)`` the threefry2x32 block of the key over the counter split
    as ``(c >> 32, c & 0xffffffff)``.

    ``keys`` is one key, a pair of ints in ``[0, 2**32)`` passed to the
    kernel as scalars (no key tensor on the card), giving an ``(n,)``
    output; or an ``(nb, 2)`` int64 tensor of key words on ``device``, of
    any strides (``keys[:, 0]`` of an ``(nb, 2, 2)`` tensor), giving
    ``(nb, n)``.  ``lo`` and ``span`` are float32 values (``rng``'s
    bounds).  The output is a new contiguous float32 tensor on ``device``;
    the launch is on the current stream, without synchronising, and
    nothing is launched for an empty output.
    """
    dev = _cuda_device(device)
    n, offset = int(n), int(offset)
    if n < 0 or offset < 0:
        raise ValueError(f"n={n} and offset={offset} must be non-negative")
    if isinstance(keys, torch.Tensor):
        if keys.dtype != torch.int64:
            raise TypeError(f"keys has dtype {keys.dtype}, expected "
                            "torch.int64")
        if keys.dim() != 2 or keys.shape[1] != 2:
            raise ValueError(f"keys has shape {tuple(keys.shape)}, "
                             "expected (nb, 2)")
        if keys.device != dev:
            raise ValueError(f"keys is on {keys.device}, expected {dev}")
        nb, shape = keys.shape[0], (keys.shape[0], n)
        strides, words = (keys.stride(0), keys.stride(1)), (0, 0)
    else:
        k0, k1 = keys
        nb, shape, strides = 1, (n,), (0, 0)
        words, keys = (int(k0) & _M32, int(k1) & _M32), None
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch("threefry", _SIGNATURES, "threefry_uniform",
                      (out, keys), *strides, *words, nb, n, offset,
                      float(lo), float(span), stream)
    uniform_threefry.launches += 1
    return out


uniform_threefry.launches = 0
