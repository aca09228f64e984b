"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``spinner_scores`` holds the score kernels' wrappers (``spinner_scores``
and ``fused_update``), ``pregel_combine`` the Pregel combine kernels'
(``pregel_reduce`` and ``pregel_combine``), ``ref`` their plain versions,
``ops`` the score-backend registry the engine uses.
"""
from . import ops, pregel_combine, ref, spinner_scores

__all__ = ["ops", "pregel_combine", "ref", "spinner_scores"]
