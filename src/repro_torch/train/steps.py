"""Train / serve step factories (the port of ``repro.train.steps``).

A train step takes the state and a batch and returns the next state and
its stats, as the reference's; like the reference's jitted step, which
donates its state, it writes the new params and AdamW moments into the
state's tensors, so the caller drops the state it passed in.

On a mesh the state and the batch are DTensors placed by
``parallel.rules`` and the step runs under
``parallel.constraints.mesh_context(mesh)``: the gradients come back at
their parameters' placements, the microbatch accumulators are made like
their parameters, and the stats are replicated scalars.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..models.common import ParamSpec, tree_leaves, tree_map, tree_unflatten
from ..models.model_zoo import ModelAPI
from ..parallel.constraints import replicate, unshard
from ..optim import adamw

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt: adamw.AdamWState
    step: torch.Tensor     # () int32


def init_train_state(params: PyTree) -> TrainState:
    return TrainState(params=params, opt=adamw.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=tree_leaves(params)[0].device))


def train_state_specs(param_specs: PyTree) -> TrainState:
    return TrainState(params=param_specs,
                      opt=adamw.state_specs(param_specs),
                      step=ParamSpec((), torch.int32))


def value_and_grad(loss: Callable, params: PyTree, batch: dict
                   ) -> Tuple[torch.Tensor, PyTree]:
    """``jax.value_and_grad(loss)(params, batch)``: the loss and the
    gradient of every leaf of ``params``, in ``params``' dtypes."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        value = loss(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(value, leaves)
    return value.detach(), tree_unflatten(params, list(grads))


def make_train_step(api: ModelAPI, opt_cfg: adamw.AdamWConfig) -> Callable:
    bf16_grads = getattr(api.cfg, "bf16_grads", False)
    n_micro = max(1, getattr(api.cfg, "microbatch", 0))

    def grad_fn(params, batch):
        if bf16_grads:
            # differentiate w.r.t. bf16 copies: the gradients are bf16;
            # AdamW math stays float32 against the float32 master params
            params = tree_map(lambda p: p.to(torch.bfloat16)
                              if p.dtype == torch.float32 else p, params)
        return value_and_grad(api.loss, params, batch)

    def train_step(state: TrainState, batch: dict
                   ) -> Tuple[TrainState, dict]:
        if n_micro > 1:
            # gradient accumulation: peak activation memory / n_micro
            micro = tree_map(lambda x: x.reshape(
                n_micro, x.shape[0] // n_micro, *x.shape[1:]), batch)
            # zeros_like: a DTensor at its parameter's placements on a mesh
            gsum = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), state.params)
            losses = []
            for i in range(n_micro):
                loss, g = grad_fn(state.params,
                                  tree_map(lambda x: x[i], micro))
                gsum = tree_map(lambda a, gg: a + gg.float(), gsum, g)
                losses.append(loss)
            n = torch.tensor(float(n_micro), device=losses[0].device)
            grads = tree_map(lambda g: g / n, gsum)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = grad_fn(state.params, batch)
        params, opt, stats = adamw.update(opt_cfg, grads, state.opt,
                                          state.params)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1)
        return new_state, {"loss": replicate(loss), **stats}

    return train_step


def make_eval_step(api: ModelAPI) -> Callable:
    @torch.no_grad()
    def eval_step(params: PyTree, batch: dict) -> torch.Tensor:
        return api.loss(params, batch)

    return eval_step


def make_prefill_step(api: ModelAPI) -> Callable:
    @torch.no_grad()
    def prefill_step(params: PyTree, batch: dict):
        return api.prefill(params, batch)

    return prefill_step


def make_decode_step(api: ModelAPI) -> Callable:
    """(params, batch, cache) -> (next token, cache); the cache is written
    in place (the reference's serving loop donates it)."""
    @torch.no_grad()
    def decode_step(params: PyTree, batch: dict, cache: PyTree):
        logits, new_cache = api.decode(params, batch, cache)
        # the vocab whole on a mesh (identity on a plain tensor)
        logits = unshard(logits[:, -1, :], -1)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, new_cache

    return decode_step
