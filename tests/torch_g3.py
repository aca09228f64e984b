"""Shared pieces of the mesh tests: parameters made with numpy from a seed,
leaf by leaf in the flattening order both packages share (dict keys
sorted), so the reference's subprocess and the port's ranks start from
the same bits without exchanging them."""
import numpy as np

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
DATA = dict(seq_len=32, global_batch=4, seed=2)


def numpy_leaves(paths_shapes, seed: int = 0) -> list:
    """One float32 array per ``(path, shape)``: ones for norms and scales,
    zeros for biases, else normal * min(0.02, fan_in ** -0.5) (the
    reference's init rules, numpy's draws)."""
    rng = np.random.default_rng(seed)
    out = []
    for path, shape in paths_shapes:
        name = path.lower()
        if "norm" in name or name.endswith("scale") or "/g_" in name:
            out.append(np.ones(shape, np.float32))
        elif "bias" in name or name.endswith("_b") or "decay0" in name:
            out.append(np.zeros(shape, np.float32))
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = min(0.02, fan_in ** -0.5)
            out.append((rng.standard_normal(shape) * std).astype(np.float32))
    return out


def step_agrees(a, b, p0, m_a, m_b, lr: float, wd: float = 0.1) -> bool:
    """One AdamW step from ``p0``: the first moments (0.1 x the clipped
    gradient) within rtol 2e-2 as a norm (the five-step tests' grad-norm
    tolerance: bf16 activations round in another order on a mesh), and
    every parameter element within a sign flip of the other run's.  The
    first update is ``lr * (g / (|g| + eps) + wd * p0)``: +-lr plus the
    decay for all but zero gradients, so an element whose gradient is near
    zero may step either way."""
    travel = lr * (1 + wd * np.abs(p0).max()) * (1 + 1e-3) + 1e-7
    return (np.linalg.norm(m_a - m_b) <= 2e-2 * np.linalg.norm(m_b)
            and np.abs(a - b).max() <= 2 * lr * (1 + 1e-3) + 1e-7
            and np.abs(b - p0).max() <= travel)
