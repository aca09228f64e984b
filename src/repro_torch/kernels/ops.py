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
scatter backend's split form.  On a mesh the scatter backend's sharded
forms read a rank's delta segment the same way (``bind.score[3:]``), and
its fused form takes ``frontier=True`` for the sharded frontier runner;
the ``"cuda"`` backend's sharded forms read no delta segment.

The sharded engine calls each backend's sharded forms on one rank's shard
(``core.distributed.RankShard``, read by ``sharded_graph_args`` and
friends): ``make_sharded_scores`` / ``make_sharded_fused_update`` score
the whole shard against the exchange plan's lookup, and the ``_split``
pairs score the interior segment against the label shard (while the
exchange is in flight) and then fold the frontier segment into that
partial.  The closures take ``(..., bind, reduce_)`` where ``bind`` is the
engine's ``ShardBind`` and ``reduce_`` sums the aggregates over the ranks.

  * ``"torch"`` -- scatter-add (``index_put_`` with accumulate) composed
    with the engine's reference halves: the oracle, the counterpart of the
    reference's XLA scatter backend.
  * ``"cuda"`` -- the hand-written CSR kernels (``spinner_scores``), the
    counterpart of the reference's Pallas backend.  Its fused entry runs
    the score reduction and the Eq. 7-8 proposal in one kernel and is on
    by default (``fused_auto``); with ``frontier=True`` it launches the
    kernel's frontier variant, and under the sharded overlap schedule the
    score kernel writes the interior partial and the fused kernel's seeded
    form folds the frontier into it.  Its split form (the dense score kernel)
    reads no delta segment.  On CPU tensors its wrappers run the plain
    versions.  Its frozen ``warps`` / ``rows`` fields are the kernels'
    tile (``None``: today's layout); the engine's autotuner binds them
    (``core.engine._autotuned``, ``kernels.autotune``), and every launch
    takes them, each form's rows cut to that form's cap (``clip_tile``).

All backends give bit-identical trajectories on the Eq. 3 weights (and on
any weights whose sums are exact, such as halves): every score sum is
then exact in float32, whatever the order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

from ..runtime import trace
from . import ref
from .spinner_scores import (clip_tile, fused_update, fused_update_frontier,
                             fused_update_seeded, spinner_scores)


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

    # ---- the sharded forms (one rank's shard) ----------------------------

    def make_sharded_scores(self, k: int, v_local: int) -> Callable:
        def scores(lookup, labels, bind):
            src, dst, w = bind.score[:3]
            return ref.spinner_scores_ref(lookup, src, dst, w, v_local, k,
                                          bind.score[3:])
        return scores

    def sharded_graph_args(self, shard) -> tuple:
        return shard.whole[1:]

    def make_sharded_scores_split(self, k: int, v_local: int) -> tuple:
        def interior(labels_local, bind):
            src, dst, w = bind.score[:3]
            return ref.spinner_scores_ref(labels_local, src, dst, w, v_local,
                                          k)

        def frontier(partial, lookup, labels, bind):
            src, dst, w = bind.score[3:]
            return ref.spinner_scores_ref(lookup, src, dst, w, v_local, k,
                                          init=partial)
        return interior, frontier

    def sharded_graph_args_split(self, shard) -> tuple:
        return shard.interior[1:] + shard.frontier[1:]

    def make_sharded_fused_update(self, k: int, v_local: int, *,
                                  degree_weighted: bool,
                                  current_bonus: float,
                                  frontier: bool = False) -> Callable:
        from ..core.engine import make_update_parts   # lazy: no cycle
        propose, finish = make_update_parts(
            k, degree_weighted=degree_weighted, current_bonus=current_bonus)
        scores_fn = self.make_sharded_scores(k, v_local)

        def fused(lookup, labels, loads, noise, u, bind, reduce_):
            scores = scores_fn(lookup, labels, bind)
            parts = propose(scores, labels, bind.deg_w, loads, noise,
                            bind.valid, bind.capacity)
            out = finish(*parts, labels, bind.deg_w, loads, u, bind.valid,
                         bind.capacity, reduce_)
            if frontier:
                # the frontier runner carries the pre-throttle want mask
                # forward as the next active set and detects the drain
                return out + ((parts[0] != labels) & bind.valid,)
            return out
        return fused

    def sharded_fused_graph_args(self, shard) -> tuple:
        return self.sharded_graph_args(shard)

    def make_sharded_fused_update_split(self, k: int, v_local: int, *,
                                        degree_weighted: bool,
                                        current_bonus: float) -> tuple:
        from ..core.engine import make_update_parts   # lazy: no cycle
        propose, finish = make_update_parts(
            k, degree_weighted=degree_weighted, current_bonus=current_bonus)
        interior, fold = self.make_sharded_scores_split(k, v_local)

        def frontier(partial, lookup, labels, loads, noise, u, bind,
                     reduce_):
            scores = fold(partial, lookup, labels, bind)
            parts = propose(scores, labels, bind.deg_w, loads, noise,
                            bind.valid, bind.capacity)
            return finish(*parts, labels, bind.deg_w, loads, u, bind.valid,
                          bind.capacity, reduce_)
        return interior, frontier

    def sharded_fused_graph_args_split(self, shard) -> tuple:
        return self.sharded_graph_args_split(shard)


@dataclasses.dataclass(frozen=True)
class CudaCsrBackend:
    """ComputeScores and the fused vertex update by the CSR kernels, at
    the tile ``(warps, rows)`` (``None``: the kernels' default)."""

    name: str = "cuda"
    warps: Optional[int] = None
    rows: Optional[int] = None
    fused_auto = True

    def tile(self, k: int, form: str):
        """The ``(warps, rows)`` a ``form`` launch at ``k`` takes (None
        when the backend carries no tile)."""
        if self.warps is None and self.rows is None:
            return None
        return clip_tile(k, form, (self.warps, self.rows))

    def make_scores(self, k: int) -> Callable:
        tile = self.tile(k, "scores")

        def scores(labels, row_ptr, dst, w):
            return spinner_scores(labels, row_ptr, dst, w, k, tile=tile)
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
        tile = self.tile(k, "frontier" if frontier else "fused")

        def fused(labels, loads, noise, u, bind):
            pen = loads / bind.capacity
            base, delta = bind.score[:3], bind.score[3:]
            with trace.span("kernels.k1", device=labels.device):
                if frontier:
                    parts = fused_update_frontier(
                        labels, *base, bind.deg_w, pen, noise, bind.valid, k,
                        current_bonus, degree_weighted, delta, tile=tile)
                else:
                    parts = fused_update(
                        labels, *base, bind.deg_w, pen, noise, bind.num_real,
                        k, current_bonus, degree_weighted, delta, tile=tile)
            out = finish(*parts, labels, bind.deg_w, loads, u, bind.valid,
                         bind.capacity)
            if frontier:
                return out + ((parts[0] != labels) & bind.valid,)
            return out
        return fused

    def fused_graph_args(self, csr) -> tuple:
        return self.graph_args(csr)

    # ---- the sharded forms (one rank's shard) ----------------------------

    def make_sharded_scores(self, k: int, v_local: int) -> Callable:
        tile = self.tile(k, "scores")

        def scores(lookup, labels, bind):
            return spinner_scores(labels, *bind.score, k, lookup=lookup,
                                  tile=tile)
        return scores

    def sharded_graph_args(self, shard) -> tuple:
        row_ptr, _, dst, w = shard.whole
        return (row_ptr, dst, w)

    def make_sharded_scores_split(self, k: int, v_local: int) -> tuple:
        """The score kernel twice: over the interior segment against the
        label shard (the overlap's interior partial), then over the
        frontier segment against the lookup, added to it."""
        tile = self.tile(k, "scores")

        def interior(labels_local, bind):
            return spinner_scores(labels_local, *bind.score[:3], k,
                                  tile=tile)

        def frontier(partial, lookup, labels, bind):
            return partial + spinner_scores(labels, *bind.score[3:], k,
                                            lookup=lookup, tile=tile)
        return interior, frontier

    def sharded_graph_args_split(self, shard) -> tuple:
        (rp_i, _, d_i, w_i), (rp_f, _, d_f, w_f) = shard.interior, \
            shard.frontier
        return (rp_i, d_i, w_i, rp_f, d_f, w_f)

    def make_sharded_fused_update(self, k: int, v_local: int, *,
                                  degree_weighted: bool,
                                  current_bonus: float) -> Callable:
        from ..core.engine import make_update_parts   # lazy: no cycle
        _, finish = make_update_parts(
            k, degree_weighted=degree_weighted, current_bonus=current_bonus)
        tile = self.tile(k, "fused")

        def fused(lookup, labels, loads, noise, u, bind, reduce_):
            parts = fused_update(labels, *bind.score, bind.deg_w,
                                 loads / bind.capacity, noise,
                                 bind.num_real_local, k, current_bonus,
                                 degree_weighted, lookup=lookup, tile=tile)
            return finish(*parts, labels, bind.deg_w, loads, u, bind.valid,
                          bind.capacity, reduce_)
        return fused

    def sharded_fused_graph_args(self, shard) -> tuple:
        return self.sharded_graph_args(shard)

    def make_sharded_fused_update_split(self, k: int, v_local: int, *,
                                        degree_weighted: bool,
                                        current_bonus: float) -> tuple:
        """The overlap form: the score kernel writes the interior partial
        while the exchange is in flight, then the fused kernel's seeded
        form starts each row from it and folds the frontier segment."""
        from ..core.engine import make_update_parts   # lazy: no cycle
        _, finish = make_update_parts(
            k, degree_weighted=degree_weighted, current_bonus=current_bonus)
        interior, _ = self.make_sharded_scores_split(k, v_local)
        tile = self.tile(k, "seeded")

        def frontier(partial, lookup, labels, loads, noise, u, bind,
                     reduce_):
            parts = fused_update_seeded(
                labels, *bind.score[3:], bind.deg_w, loads / bind.capacity,
                noise, bind.num_real_local, k, current_bonus,
                degree_weighted, partial, lookup=lookup, tile=tile)
            return finish(*parts, labels, bind.deg_w, loads, u, bind.valid,
                          bind.capacity, reduce_)
        return interior, frontier

    def sharded_fused_graph_args_split(self, shard) -> tuple:
        return self.sharded_graph_args_split(shard)


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
