"""Graph generators on the device.

Each ``graphs/<name>.py`` holds one generator, found by the name a
configuration gives under ``graph.generator``: ``edges(spec, seed,
device) -> (src, dst, num_vertices)``, a directed int64 edge list drawn
from ``seed`` on ``device``.  ``build`` turns it into the weighted
undirected CSR of Eq. 3 on the device (``assemble``) and copies it to the
host arrays the program's ``Graph`` holds.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from .assemble import assemble


def generator(name: str):
    """The generator module ``graphs/<name>.py``."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad generator name {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def build(spec: dict, seed: int, device) -> dict:
    """The configuration's graph from ``seed``, made on ``device``: the
    host arrays of the symmetric CSR (``src``, ``dst``, ``weight``,
    ``row_ptr``, ``deg_w``) and ``num_vertices``."""
    src, dst, n = generator(spec["generator"]).edges(spec, seed, device)
    csr = assemble(src, dst, n)
    del src, dst
    out = {name: t.cpu().numpy() for name, t in csr.items()}
    out["num_vertices"] = int(n)
    return out


def seeded(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded from any non-negative int."""
    words = np.random.SeedSequence(int(seed)).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(words[0]) << 32 | int(words[1]))
    return g
