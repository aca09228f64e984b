"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``spinner_scores`` holds the kernels' wrappers (``spinner_scores`` and
``fused_update``), ``ref`` their plain versions, ``ops`` the score-backend
registry the engine uses.
"""
from . import ops, ref, spinner_scores

__all__ = ["ops", "ref", "spinner_scores"]
