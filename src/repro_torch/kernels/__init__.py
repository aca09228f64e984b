"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``spinner_scores`` holds the score kernels' wrappers (``spinner_scores``,
``fused_update`` and its frontier variant ``fused_update_frontier``),
``pregel_combine`` the Pregel combine kernels'
(``pregel_reduce`` and ``pregel_combine``), ``ref`` their plain versions,
``ops`` the score-backend registry the engine uses, ``autotune`` the
score kernels' tile autotuner, ``threefry`` the threefry uniform kernel's
(``uniform_threefry``, ``rng.uniform``'s card half; its plain version is
``rng._uniform_plain``).
"""
from . import autotune, ops, pregel_combine, ref, spinner_scores, threefry

__all__ = ["autotune", "ops", "pregel_combine", "ref", "spinner_scores",
           "threefry"]
