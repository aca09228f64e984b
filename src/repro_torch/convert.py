"""Carry a reference run's graph and state across into the port.

Both functions are duck-typed on host arrays, so this module imports
nothing of the reference package: the caller hands over numpy views.

  * ``graph_from_reference(g)`` reads ``num_vertices / src / dst / weight
    / row_ptr / deg_w``.
  * ``state_from_reference(s)`` takes a reference ``SpinnerState`` turned
    into host arrays (e.g. ``jax.device_get(state)``) or the dict of
    ``PartitionSession.export_state()``: labels, loads and the threefry
    key as ``uint32[2]`` (``key`` or ``rng_key``), plus the halting
    aggregates where the source has them.  The port then continues the
    same run: same key stream, same halting state.
  * ``params_from_reference(tree, device)`` takes a model's parameter
    pytree as nested host arrays (``jax.device_get(params)``) and gives
    the port's parameters: the same keys, shapes and dtypes, leaf for leaf
    (bf16 arrives as ``ml_dtypes.bfloat16`` and leaves as
    ``torch.bfloat16``).
  * ``train_state_from_reference(s, device)`` does the same for a whole
    ``TrainState`` (params, AdamW step / m / v, step).
  * ``cache_from_reference(c, device)`` takes a model's decode cache or
    recurrent state as nested host arrays -- ``KVCache``, ``RWKVState``,
    ``ZambaState`` (its ``MambaState``s and its ``pos`` scalar),
    ``EncDecCache`` or ``VLMCache`` -- and gives the port's, each
    NamedTuple matched by its class name.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.engine import SpinnerState, init_state
from .core.graph import Graph
from .models.attention import KVCache
from .models.common import tree_map
from .models.encdec import EncDecCache
from .models.rwkv import RWKVState
from .models.ssm import MambaState, ZambaState
from .models.vlm import VLMCache
from .optim.adamw import AdamWState
from .train.steps import TrainState

# reference SpinnerState fields carried over when present: name -> dtype
_CARRIED = {"best_score": torch.float32, "stall": torch.int32,
            "iteration": torch.int32, "halted": torch.bool,
            "total_messages": torch.float32, "score": torch.float32,
            "migrations": torch.int32, "message_mass": torch.float32,
            "exchanged_bytes": torch.float32}
_CACHES = {c.__name__: c for c in (KVCache, RWKVState, MambaState, ZambaState,
                                   EncDecCache, VLMCache)}


def graph_from_reference(g) -> Graph:
    """The port's ``Graph`` with the reference graph's arrays."""
    return Graph(num_vertices=int(g.num_vertices),
                 src=np.asarray(g.src, np.int32),
                 dst=np.asarray(g.dst, np.int32),
                 weight=np.asarray(g.weight, np.float32),
                 row_ptr=np.asarray(g.row_ptr, np.int64),
                 deg_w=np.asarray(g.deg_w, np.float32))


def state_from_reference(s, device) -> SpinnerState:
    """The port's ``SpinnerState`` on ``device`` continuing reference state
    ``s`` (a state with host arrays, or an ``export_state()`` dict)."""
    fields = dict(s) if isinstance(s, dict) else s._asdict()
    key = fields.get("key", fields.get("rng_key"))
    if key is None:
        raise ValueError("reference state carries no key ('key' or "
                         "'rng_key')")
    key = np.asarray(key, np.uint32).reshape(2)
    state = init_state(np.asarray(fields["labels"], np.int32),
                       np.asarray(fields["loads"], np.float32),
                       (int(key[0]), int(key[1])), device=device)
    carried = {name: torch.tensor(np.asarray(fields[name]).item(),
                                  dtype=dtype, device=state.labels.device)
               for name, dtype in _CARRIED.items() if name in fields}
    return state._replace(**carried)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy twin
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_reference(tree, device):
    """The port's parameter tree on ``device`` from a reference pytree of
    host arrays (nested dicts and NamedTuples, keys kept)."""
    return tree_map(lambda a: _tensor(a, device), tree)


def train_state_from_reference(s, device) -> TrainState:
    """The port's ``TrainState`` on ``device`` continuing reference
    ``TrainState`` ``s`` (host arrays): the same params, AdamW moments and
    step counters, so the port's next step is the reference's."""
    opt = s.opt
    return TrainState(
        params=params_from_reference(s.params, device),
        opt=AdamWState(step=_tensor(opt.step, device).to(torch.int32),
                       m=params_from_reference(opt.m, device),
                       v=params_from_reference(opt.v, device)),
        step=_tensor(s.step, device).to(torch.int32))


def cache_from_reference(c, device):
    """The port's decode cache or recurrent state on ``device`` from a
    reference one of host arrays (``jax.device_get(cache)``)."""
    if isinstance(c, tuple) and hasattr(c, "_fields"):
        return _CACHES[type(c).__name__](
            *(cache_from_reference(x, device) for x in c))
    return _tensor(c, device)
