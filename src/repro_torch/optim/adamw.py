"""AdamW + global-norm clipping + warmup-cosine schedule.

The port of ``repro.optim.adamw``, computed as the reference computes it:
the gradients scaled by the global-norm clip, the moments, the bias
corrections, and the decay term inside ``delta``, scaled by ``lr``, with
the reference's order of operations.  It is not ``torch.optim.AdamW``,
which applies the decay as a separate multiply and rounds differently.

``update`` writes the new params, m and v into the given tensors (the
reference's train step donates its state, so its update is in place too)
and returns them.  The scalars (step, lr, bias corrections, clip scale)
are 0-d tensors on the parameters' device: a step reads nothing back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from ..models.common import ParamSpec, tree_leaves, tree_map

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32
    m: PyTree
    v: PyTree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac * lr."""
    step = step.float()
    warm = step / _f32(max(1.0, cfg.warmup_steps), step)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(1.0, cfg.total_steps - cfg.warmup_steps),
                              step), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: PyTree) -> AdamWState:
    # zeros_like: on a mesh each moment is a DTensor at its parameter's
    # placements
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(step=step, m=zeros, v=tree_map(torch.clone, zeros))


def state_specs(param_specs: PyTree) -> AdamWState:
    z = tree_map(lambda p: ParamSpec(p.shape, torch.float32), param_specs)
    return AdamWState(step=ParamSpec((), torch.int32), m=z, v=z)


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
           params: PyTree) -> Tuple[PyTree, AdamWState, dict]:
    """One AdamW step; params, m and v are updated in place."""
    step = state.step + 1
    gnorm = global_norm(grads)
    # tensor / tensor throughout: PyTorch computes ``float / tensor`` as a
    # reciprocal times the float, which can differ from the quotient
    scale = torch.clamp_max(_f32(cfg.clip_norm, gnorm)
                            / torch.clamp_min(gnorm, 1e-9), 1.0)
    stepf = step.float()
    bc1 = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)
    lr = schedule(cfg, step)
    ps, ms, vs = (tree_leaves(t) for t in (params, state.m, state.v))
    for p, g, m, v in zip(ps, tree_leaves(grads), ms, vs):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay \
            * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
