"""Sharding rules and activation constraints on DTensor (the port of
``repro.parallel``)."""
from . import constraints, rules
from .rules import (batch_shardings, cache_shardings, fsdp_axes,
                    param_shardings, replicated, shard_tree)

__all__ = ["batch_shardings", "cache_shardings", "constraints",
           "fsdp_axes", "param_shardings", "replicated", "rules",
           "shard_tree"]
