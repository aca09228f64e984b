"""Kind ``partition``: a closed loop of whole partitions from scratch.

Each call runs ``partition()`` from its own uniform random labels, with
its own seed of the program's random streams, to the halt (Section 3.3):
on the program the one-shot ``repro_torch.core.partition``, a throwaway
session, as a caller that partitions from scratch makes it.  The check
recomputes a sample of the window's calls from the same inputs.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

from portbench.kinds import entry, span, timed
from portbench.reference import spinner as ref

KIND = "partition"


def answer(system, init, seed=None) -> ref.Answer:
    """``system``'s partition from labels ``init`` (its own seed if
    ``seed`` is None)."""
    return entry(sys.modules[__name__], system)(system, init, seed)


def on_port(system, init, seed) -> ref.Answer:
    from repro_torch.core import partition

    if seed is None:
        return system.answer(system.session.partition(init=init))
    cfg = dataclasses.replace(system.cfg, seed=int(seed))
    return system.answer(partition(system.graph, cfg, init=init,
                                   options=system.opts))


def on_control(system, init, seed) -> ref.Answer:
    ans = ref.run(system.edges, system.params, torch.from_numpy(init),
                  ref.capacity(system.params, system.base_total),
                  system.seed if seed is None else int(seed), system.dtype)
    system.state["labels"] = ans.labels
    return ans


def setup(run, system) -> int:
    return 0


def call(run, system, j: int, traced: bool) -> dict:
    t = run.traffic
    with span("init_gen", traced):
        init = t.init_labels(j)
    with span("partition", traced):
        ans, seconds = timed(run.device, answer, system, init,
                             t.spinner_seed(j))
    return {"kind": KIND, "input": j, "seconds": seconds,
            "iterations": ans.iterations, "answer": ans}


def check(run, judge, picked: list) -> None:
    t = run.traffic
    for i in picked:
        j = run.window[i]["input"]
        judge.against(run.window[i]["answer"], judge.edges, t.init_labels(j),
                      judge.base_total, t.spinner_seed(j))
