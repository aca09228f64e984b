"""The score-backend registry: how an iteration computes ComputeScores.

A backend is split, as in the reference, into graph-independent closures
(``make_scores`` / ``make_fused_update``) and the per-graph device arrays
they consume (``graph_args`` / ``fused_graph_args``, read off the padded
graph's ``DeviceCSR``).  The engine calls ``scores(labels, *args)`` for
the split path and ``fused(labels, loads, noise, u, bind)`` for the fused
vertex update, which returns the whole iteration's outputs (plus the
``want`` mask with ``frontier=True``, where ``bind.valid`` is the
frontier's ``real & active`` mask).  A session's on-device delta
(``core.delta``) appends a second edge segment to the arg tuple
(``delta_args``): both backends' fused forms read it, and so does the
scatter backend's split form.

  * ``"torch"`` -- scatter-add (``index_put_`` with accumulate) composed
    with the engine's reference halves: the oracle, the counterpart of the
    reference's XLA scatter backend.
  * ``"cuda"`` -- the hand-written CSR kernels (``spinner_scores``), the
    counterpart of the reference's Pallas backend.  Its fused entry runs
    the score reduction and the Eq. 7-8 proposal in one kernel and is on
    by default (``fused_auto``); with ``frontier=True`` it launches the
    kernel's frontier variant.  Its split form (the dense score kernel)
    reads no delta segment.  On CPU tensors its wrappers run the plain
    versions.

All backends give bit-identical trajectories: every score sum is an exact
integer in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

from . import ref
from .spinner_scores import (fused_update, fused_update_frontier,
                             spinner_scores)


@dataclasses.dataclass(frozen=True)
class TorchScatterBackend:
    """ComputeScores by PyTorch scatter-add -- the kernels' oracle."""

    name: str = "torch"
    fused_auto = False

    def make_scores(self, k: int) -> Callable:
        def scores(labels, src, dst, w, *delta):
            return ref.spinner_scores_ref(labels, src, dst, w,
                                          labels.shape[0], k, delta)
        return scores

    def graph_args(self, csr) -> tuple:
        return (csr.src, csr.dst, csr.weight)

    def delta_args(self, dd) -> tuple:
        return (dd.src, dd.dst, dd.w)

    def make_fused_update(self, k: int, *, degree_weighted: bool,
                          current_bonus: float,
                          frontier: bool = False) -> Callable:
        from ..core.engine import make_update_parts   # lazy: no cycle
        propose, finish = make_update_parts(
            k, degree_weighted=degree_weighted, current_bonus=current_bonus)
        scores_fn = self.make_scores(k)

        def fused(labels, loads, noise, u, bind):
            scores = scores_fn(labels, *bind.score)
            parts = propose(scores, labels, bind.deg_w, loads, noise,
                            bind.valid, bind.capacity)
            out = finish(*parts, labels, bind.deg_w, loads, u, bind.valid,
                         bind.capacity)
            if frontier:
                return out + ((parts[0] != labels) & bind.valid,)
            return out
        return fused

    def fused_graph_args(self, csr) -> tuple:
        return self.graph_args(csr)


@dataclasses.dataclass(frozen=True)
class CudaCsrBackend:
    """ComputeScores and the fused vertex update by the CSR kernels."""

    name: str = "cuda"
    fused_auto = True

    def make_scores(self, k: int) -> Callable:
        def scores(labels, row_ptr, dst, w):
            return spinner_scores(labels, row_ptr, dst, w, k)
        return scores

    def graph_args(self, csr) -> tuple:
        return (csr.row_ptr, csr.dst, csr.weight)

    def delta_args(self, dd) -> tuple:
        return (dd.row_ptr, dd.dst, dd.w)

    def make_fused_update(self, k: int, *, degree_weighted: bool,
                          current_bonus: float,
                          frontier: bool = False) -> Callable:
        from ..core.engine import make_update_parts   # lazy: no cycle
        _, finish = make_update_parts(
            k, degree_weighted=degree_weighted, current_bonus=current_bonus)

        def fused(labels, loads, noise, u, bind):
            pen = loads / bind.capacity
            base, delta = bind.score[:3], bind.score[3:]
            if frontier:
                parts = fused_update_frontier(
                    labels, *base, bind.deg_w, pen, noise, bind.valid, k,
                    current_bonus, degree_weighted, delta)
            else:
                parts = fused_update(labels, *base, bind.deg_w, pen, noise,
                                     bind.num_real, k, current_bonus,
                                     degree_weighted, delta)
            out = finish(*parts, labels, bind.deg_w, loads, u, bind.valid,
                         bind.capacity)
            if frontier:
                return out + ((parts[0] != labels) & bind.valid,)
            return out
        return fused

    def fused_graph_args(self, csr) -> tuple:
        return self.graph_args(csr)


SCORE_BACKENDS = {
    "torch": TorchScatterBackend(),
    "cuda": CudaCsrBackend(),
}


def get_score_backend(backend: Union[str, object]):
    """Resolve a backend name; backend instances pass through unchanged."""
    if isinstance(backend, str):
        try:
            return SCORE_BACKENDS[backend]
        except KeyError:
            raise ValueError(
                f"unknown score backend {backend!r}; "
                f"available: {sorted(SCORE_BACKENDS)}") from None
    return backend
