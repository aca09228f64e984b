"""One run of one cell: set-up, the measured window, the trace, the check.

``run_cell`` drives a system (the program, or the control in its place)
with the cell's traffic and returns the result object that ``run.py``
prints.  It never looks for a chip itself, so the CPU tests drive it
whole at a tiny size on ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import graphs
from ..reference import spinner as ref
from . import check, spec, trace
from .systems import PortSystem
from .traffic import Traffic


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class Run:
    """What a run measured and kept for the metrics and the check."""

    config: dict
    traffic: Traffic
    device: object
    sample_seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    setup: list = dataclasses.field(default_factory=list)
    window: list = dataclasses.field(default_factory=list)
    traced: list = dataclasses.field(default_factory=list)
    failed: int = 0
    trace: Optional[dict] = None
    padded_shape: tuple = ()

    def calls(self, kind: str) -> list:
        return [c for c in self.window if c["kind"] == kind]


class Seeds:
    """The run's sub-seeds, all drawn from ``--seed``."""

    def __init__(self, seed: int):
        words = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(
            3, np.uint32)
        self.spinner, self.traffic, self.sample = (int(w) for w in words)


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, device,
             t_start: float, bench: Optional[dict] = None,
             system_cls=PortSystem, log: Callable = None,
             config: Optional[dict] = None, mix: Optional[dict] = None
             ) -> tuple:
    """One run of cell ``name``.  Returns ``(result, checks)``: the result
    object (without ``checks``) and the numbers compared with their
    limits.  ``config`` and ``mix`` replace the cell's configuration and
    traffic files (the tests' tiny sizes)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = bench if bench is not None else spec.bench()
    cell = spec.workload(bench, name)
    config = config if config is not None else spec.config(cell["config"])
    mix = mix if mix is not None else spec.traffic(cell["traffic"])
    kind = spec.kind(mix["kind"])
    seeds = Seeds(seed)
    params = ref.Params.from_config(config["spinner"])

    # ---- set-up: the graph on the device, the system, warm-up ----------
    # (the configuration's graph: the same in every run, made anew)
    t0 = time.perf_counter()
    graph = graphs.build(config["graph"], int(config["graph"]["seed"]),
                         device)
    _sync(device)
    log(f"graph: {graph['num_vertices']} vertices, {graph['src'].shape[0]} "
        f"directed entries, made in {time.perf_counter() - t0:.3f} s, at "
        f"{time.perf_counter() - t_start:.3f} s")
    traffic = Traffic(mix, graph, params.k, seeds.traffic, device)
    run = Run(config=config, traffic=traffic, device=device,
              sample_seed=seeds.sample)
    system = system_cls(graph, config, seeds.spinner, device,
                        traffic.init_labels(-1))
    _sync(device)
    log(f"system warm at {time.perf_counter() - t_start:.3f} s")
    next_input = kind.setup(run, system)
    _sync(device)
    run.setup_s = time.perf_counter() - t_start
    run.padded_shape = system.stats()["padded_shape"]
    log(f"set-up {run.setup_s:.3f} s, padded shape {run.padded_shape}")

    # ---- the window ------------------------------------------------------
    budget = int(mix.get("max_batches", 1 << 62)) - next_input \
        - (int(mix.get("traced_calls", 1)) if trace_on else 0)
    w0 = time.perf_counter()
    try:
        while budget > 0:
            c = kind.call(run, system, next_input, False)
            next_input += 1
            budget -= 1
            run.window.append(c)
            if time.perf_counter() - w0 >= seconds:
                break
    except Exception as exc:            # a call that raised: failed, and
        run.failed += 1                 # the window ends there
        log(f"call {next_input} raised {type(exc).__name__}: {exc}")
    run.window_s = time.perf_counter() - w0
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if torch.device(device).type == "cuda" else 0)
    log(f"window {run.window_s:.3f} s, {len(run.window)} calls, seconds "
        f"{[round(c['seconds'], 4) for c in run.window]}, iterations "
        f"{[c['iterations'] for c in run.window]}")

    # ---- the traced calls, after the window ------------------------------
    if trace_on and not run.failed:
        def traced():
            for i in range(int(mix.get("traced_calls", 1))):
                run.traced.append(kind.call(run, system, next_input + i,
                                            True))
        with trace.program_spans(system.name == "port"):
            run.trace = trace.capture(
                traced,
                spec.ROOT / "build" / "portbench" / f"trace-{seed}.json")
        log(f"traced {run.trace['window_s']:.3f} s, device busy "
            f"{run.trace['busy_s']:.3f} s")

    metrics = {}
    group = "per_layer" if trace_on else "end_to_end"
    units = {m["name"]: m["unit"] for m in bench[group]}
    for mname in spec.metrics_for(bench, name, group):
        value = spec.metric(mname).read(run)
        if value is not None:
            metrics[mname] = {"value": value, "unit": units[mname]}

    # ---- the check, with the program's state freed -----------------------
    system.close()
    del system
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    nums = check.check(run, graph, params, seeds.spinner, device, log, kind)
    correct = check.verdict(nums, run.failed)
    result = {"correct": correct, "attempted": len(run.window) + run.failed,
              "failed": run.failed, "metrics": metrics,
              "device": {"memory_peak_bytes": int(memory_peak)}}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = trace.breakdown(run.trace)
    checks = {n: [nums[n], limit] for n, limit in check.LIMITS.items()}
    return result, checks
