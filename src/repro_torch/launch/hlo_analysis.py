"""Per-device op analysis of an eager step (the port of
``repro.launch.hlo_analysis``).

The reference parses compiled XLA HLO and weights each ``while`` body by
its trip count.  Eager PyTorch has no HLO: :class:`OpAnalysis` is a
``TorchDispatchMode`` that counts what a step dispatches.  It steps aside
for DTensor (a mode returns ``NotImplemented`` for a DTensor op), so it
sees one rank's local aten ops and the c10d collectives DTensor emits --
per device, as the reference's numbers are.  Every executed op is
counted, so a Python loop over layers or chunks needs no trip-count
weighting.  Under ``FakeTensorMode`` nothing is allocated (the dry run).

  * dot FLOPs       2 * prod(result dims) * contraction, per ``mm`` /
                    ``bmm`` / ``addmm`` / ``baddbmm`` (and their
                    ``out_dtype`` forms), on the local tensors.
  * HBM bytes       per op: input + output tensor bytes -- eager traffic,
                    every op a kernel, nothing fused; views move nothing.
  * collective bytes / counts   per kind (the reference's names), the
                    result bytes of each; an all-reduce charged 2x (ring
                    reduce-scatter + all-gather phases).
  * peak bytes      the peak of live tensor storage the step allocated
                    (each storage counted from its first op output until
                    it is freed).

The reference's ``tpu_bytes`` (the bytes left if XLA-TPU fused every
elementwise chain) is a TPU cost model and is not carried into the port.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_DOTS = {"mm", "bmm", "addmm", "baddbmm"}

# collective op name (aten-style, either c10d namespace) -> the
# reference's kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor_coalesced":
    "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_":
    "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}


# ops that allocate or read metadata and move no tensor data
_NO_TRAFFIC = {"empty", "empty_strided", "new_empty", "new_empty_strided",
               "empty_like", "_local_scalar_dense", "detach", "lift_fresh",
               "wait_tensor"}


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _dot_flops(name: str, args, out) -> float:
    """2 * prod(result dims) * the contraction length."""
    if name in ("addmm", "baddbmm"):
        a = args[1]
    else:
        a = args[0]
    return 2.0 * out.numel() * a.shape[-1]


class OpAnalysis(TorchDispatchMode):
    """Counts the local ops dispatched under it; :meth:`record` gives the
    reference's keys (``dot_flops``, ``hbm_bytes``, ``bytes_by_op``,
    ``collectives`` by kind with count and bytes, ``collective_bytes``)
    plus ``n_ops`` and ``peak_bytes``."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.by_op: Dict[str, float] = {}
        self.coll: Dict[str, dict] = {}
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakKeyDictionary()
        self._hidden = 0
        self._unpatch = None

    def __enter__(self):
        # DTensor derives each op's output shape by running it on
        # global-shape fake tensors: not the device's work, not counted
        try:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator as SP
            orig = SP._propagate_tensor_meta_non_cached
        except (ImportError, AttributeError):
            return super().__enter__()

        def hidden(prop, *a, **k):
            self._hidden += 1
            try:
                return orig(prop, *a, **k)
            finally:
                self._hidden -= 1

        SP._propagate_tensor_meta_non_cached = hidden
        self._unpatch = lambda: setattr(
            SP, "_propagate_tensor_meta_non_cached", orig)
        return super().__enter__()

    def __exit__(self, *exc):
        if self._unpatch is not None:
            self._unpatch()
            self._unpatch = None
        return super().__exit__(*exc)

    def _freed(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._freed, n)
            self.live += n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor run its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._hidden:
            return out
        self.n_ops += 1
        name = func.__name__.split(".")[0]
        ns = func.namespace
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            nbytes = sum(_bytes(t) for t in outs)
            if kind == "all-reduce":
                nbytes *= 2
            e = self.coll.setdefault(kind, {"count": 0, "bytes": 0.0})
            e["count"] += 1
            e["bytes"] += nbytes
            self._track(outs)
            return out
        if ns == "aten" and name in _DOTS and outs:
            self.dot_flops += _dot_flops(name, args, outs[0])
        schema = func._schema
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        if ns == "aten" and not view and name not in _NO_TRAFFIC:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            b = float(sum(_bytes(t) for t in ins) + sum(_bytes(t)
                                                         for t in outs))
            self.hbm_bytes += b
            self.by_op[name] = self.by_op.get(name, 0.0) + b
            if not any(r.alias_info is not None for r in schema.returns):
                self._track(outs)
        return out

    def record(self) -> dict:
        coll = {k: dict(v) for k, v in self.coll.items()}
        top = dict(sorted(self.by_op.items(), key=lambda kv: -kv[1])[:12])
        return {
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.hbm_bytes,
            "bytes_by_op": top,
            "collectives": coll,
            "collective_bytes": sum(v["bytes"] for v in coll.values()),
            "n_ops": self.n_ops,
            "peak_bytes": self.peak,
        }


def tensor_bytes(tree) -> int:
    """The local bytes of every tensor in ``tree`` (a DTensor counts its
    own shard): the per-device argument / output bytes."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        total += _bytes(t)
    return total


