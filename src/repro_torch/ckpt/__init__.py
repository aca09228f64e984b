"""Atomic checkpoints of array and tensor trees (``checkpoint``)."""
from . import checkpoint

__all__ = ["checkpoint"]
