"""What a cell drives: the program under test, or the control in its place.

Each holds its state for one run: the configuration's graph, Spinner's
parameters and the run's seed, and a ``state`` dict the kinds keep their
own things in.  The calls themselves are the kinds' (``kinds/<kind>.py``:
``on_port`` and ``on_control``); ``stats()`` gives the counters the
metrics and the kinds read.

* ``PortSystem`` is the program on the fused runner, the CUDA kernels at
  the tile autotuner's pick, with one ``PartitionSession`` open.
* ``ControlSystem`` is the plain reference computed in bfloat16 (the
  precision below the float32 the configuration states): the comparison
  must find it wrong.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..reference import spinner as ref


class PortSystem:
    name = "port"

    def __init__(self, graph: dict, config: dict, seed: int, device,
                 warm_init: np.ndarray):
        from repro_torch.core import EngineOptions, SpinnerConfig, partition
        from repro_torch.core.graph import Graph
        from repro_torch.core.session import PartitionSession

        self.graph = Graph(num_vertices=graph["num_vertices"],
                           src=graph["src"], dst=graph["dst"],
                           weight=graph["weight"], row_ptr=graph["row_ptr"],
                           deg_w=graph["deg_w"])
        sp = config["spinner"]
        self.cfg = SpinnerConfig(
            k=sp["k"], c=sp["c"], eps=sp["eps"], halt_window=sp["halt_window"],
            max_iters=sp["max_iters"], seed=int(seed))
        self.opts = EngineOptions(engine="fused", device=device)
        self.state = {}
        # two iterations bind the autotuner's tile, upload the padded graph
        # and size the allocator for this cell's shapes
        partition(self.graph, dataclasses.replace(self.cfg, max_iters=2),
                  init=warm_init, options=self.opts)
        self.session = PartitionSession(self.graph, self.cfg, self.opts)

    @staticmethod
    def answer(res) -> ref.Answer:
        return ref.Answer(labels=res.labels, loads=res.loads,
                          iterations=res.iterations, halted=res.halted)

    def stats(self) -> dict:
        s = self.session.stats()
        return {"padded_shape": tuple(s["padded_shape"]), **s["delta"]}

    def close(self) -> None:
        self.session.close()
        self.session = self.graph = self.state = None


class ControlSystem:
    name = "control"

    def __init__(self, graph: dict, config: dict, seed: int, device,
                 warm_init: np.ndarray, dtype=torch.bfloat16):
        self.params = ref.Params.from_config(config["spinner"])
        self.seed, self.dtype, self.device = int(seed), dtype, device
        self.edges = ref.host_edges(graph, device)
        n = graph["num_vertices"]
        self.base_total = ref.float32_total(self.edges.deg[:n].cpu().numpy())
        self.shape = (self.edges.v_pad,
                      ref.shape_bucket(graph["src"].shape[0], 128))
        self.state = {}

    def stats(self) -> dict:
        return {"padded_shape": self.shape}

    def close(self) -> None:
        self.edges = self.state = None
