"""Whole runs at a tiny size on the CPU: the program comes out correct;
the control, and the program broken underneath, come out not correct."""
import json
import runpy
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench.harness import check, spec, trace
from portbench.harness.systems import ControlSystem

import repro_torch.core.engine as engine
from repro_torch.core.session import PartitionSession

CELLS = [w["name"] for w in spec.bench()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(run_tiny, cell):
    result, checks = run_tiny(cell)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(checks) <= set(check.LIMITS)
    assert all(v == lim for v, lim in checks.values())
    names = set(spec.metrics_for(spec.bench(), cell, "end_to_end"))
    assert set(result["metrics"]) == names
    assert all(m["value"] > 0 for m in result["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(run_tiny, cell):
    result, checks = run_tiny(cell, system_cls=ControlSystem)
    assert not result["correct"]
    assert checks["label_mismatch"][0] > checks["label_mismatch"][1]


def _stuck_iterate(cfg, opts):
    """A step that returns its state unchanged."""
    import torch

    def iterate(labels, loads, key, bind):
        z = torch.zeros((), device=labels.device)
        return labels, loads, z, z.to(torch.int32), z
    return iterate


def _altered_chunk_loop(orig):
    """Every run's answer with one label altered where it is produced."""
    def loop(cfg, state, *a, **kw):
        state, hist = orig(cfg, state, *a, **kw)
        labels = state.labels.clone()
        labels[0] = (labels[0] + 1) % cfg.k
        return state._replace(labels=labels), hist
    return loop


def _half_batch_adapt(orig):
    """Each batch of new edges with half of it left out."""
    def adapt(self, *a, edge_updates=None, **kw):
        if edge_updates is not None:
            src, dst = edge_updates
            edge_updates = (src[:len(src) // 2], dst[:len(dst) // 2])
        return orig(self, *a, edge_updates=edge_updates, **kw)
    return adapt


FAULTS = {
    "unchanged_state": lambda mp: mp.setattr(engine, "make_iterate",
                                             _stuck_iterate),
    "altered_answer": lambda mp: mp.setattr(
        engine, "_chunk_loop", _altered_chunk_loop(engine._chunk_loop)),
    "half_batch": lambda mp: mp.setattr(
        PartitionSession, "adapt", _half_batch_adapt(PartitionSession.adapt)),
}
CASES = [(c, f) for c in CELLS for f in FAULTS
         if f != "half_batch" or c.endswith(".adapt")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_broken_program_is_not_correct(run_tiny, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    result, checks = run_tiny(cell)
    assert not result["correct"], checks


def test_result_line_has_the_contract_keys(run_tiny):
    run = runpy.run_path(str(spec.HERE / "run.py"))
    result, checks = run_tiny(CELLS[0])
    line = run["result_line"](result, checks, "a card", 1)
    assert list(line) == KEYS
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["device"]["platform"] == "gpu"
    json.loads(json.dumps(line))
    assert run["banned_modules"]() == []


def test_run_without_a_card_prints_no_result(tmp_path):
    # a checkout of the benchmark alone: BENCHMARK.json and its paths
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout == ""


def test_trace_reduction():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "trace_window",
           "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "cat": "user_annotation", "name": "partition",
           "ts": 100.0, "dur": 800.0},
          {"ph": "X", "cat": "user_annotation", "name": "draws",
           "ts": 110.0, "dur": 20.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 115.0, "dur": 2.0, "args": {"correlation": 7}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 140.0, "dur": 2.0, "args": {"correlation": 8}},
          {"ph": "X", "cat": "kernel", "name": "fused_update_kernel<0>",
           "ts": 150.0, "dur": 100.0, "args": {"correlation": 8}},
          {"ph": "X", "cat": "kernel", "name": "add", "ts": 200.0,
           "dur": 100.0, "args": {"correlation": 7}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 600.0,
           "dur": 50.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 10.0,
           "dur": 5.0}]
    t = trace.reduce(ev)
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(200e-6)
    assert t["kernels"]["fused_update_kernel<0>"] == (pytest.approx(1e-4), 1)
    assert t["gaps"][0] == ("partition", pytest.approx(350e-6))
    assert ("partition", pytest.approx(300e-6)) in t["gaps"]
    assert ("host", pytest.approx(150e-6)) in t["gaps"]
    # by the innermost span around each launch, not around the work
    assert t["span_device_s"] == {"draws": pytest.approx(1e-4),
                                  "partition": pytest.approx(1e-4)}
    b = trace.breakdown(t)
    assert len(b["device_ops"]) == 2 and len(b["idle_gaps"]) <= 10


def test_sample_is_drawn_from_the_seed():
    a = check.sample(50, 3, 2 ** 31 + 9)
    assert a == check.sample(50, 3, 2 ** 31 + 9)
    assert len(set(a)) == 3 and all(0 <= i < 50 for i in a)
    assert check.sample(1, 3, 5) == [0]
    assert np.unique([tuple(check.sample(50, 3, s)) for s in range(8)],
                     axis=0).shape[0] > 1


def test_adapt_off_the_fast_path_fails_the_run(run_tiny):
    # batches that overflow the edge bucket's slack: the session falls
    # back to the host rebuild, which the mix is sized never to need
    import time

    from portbench.tests.conftest import tiny
    from portbench.harness import cell as cell_mod

    name = next(c for c in CELLS if c.endswith(".adapt"))
    config, mix = tiny(name)
    mix.update(pairs_per_batch=400, max_batches=40)
    with pytest.raises(RuntimeError, match="fast path"):
        # the warm batch in set-up already overflows: the run stops there
        cell_mod.run_cell(name, 5, 0.5, False, "cpu", time.perf_counter(),
                          config=config, mix=dict(mix, pairs_per_batch=4000),
                          log=lambda m: None)
    result, _ = cell_mod.run_cell(name, 5, 30.0, False, "cpu",
                                  time.perf_counter(), config=config, mix=mix,
                                  log=lambda m: None)
    assert result["failed"] == 1 and not result["correct"]


def test_program_spans_wrap_the_draws_and_put_them_back():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.rng as rng

    orig = rng.uniform
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.program_spans():
            assert rng.uniform is not orig
            a = rng.uniform(rng.PRNGKey(3), (64, 4), device="cpu")
    assert rng.uniform is orig
    assert torch.equal(a, orig(rng.PRNGKey(3), (64, 4), device="cpu"))
    assert any(e.name == "draws" for e in prof.events())
    with trace.program_spans(False):
        assert rng.uniform is orig


def test_kinds_are_found_by_name():
    for name in ("partition", "adapt"):
        assert spec.kind(name).KIND == name
    with pytest.raises(ValueError):
        spec.kind("../cell")
    with pytest.raises(ModuleNotFoundError):
        spec.kind("no_such_kind")


def test_degree_endpoints_on_a_power_law_graph(run_tiny):
    # a mix that draws each batch's endpoints by degree, on a skewed graph:
    # data alone, run whole and held to the reference
    import time

    from portbench import graphs
    from portbench.harness import cell as cell_mod
    from portbench.harness.traffic import Traffic
    from portbench.tests.conftest import TINY_GRAPH, tiny

    name = next(c for c in CELLS if c.endswith(".adapt"))
    config, mix = tiny(name)
    config["graph"] = dict(generator="chung_lu", exponent=2.1, seed=4,
                           **TINY_GRAPH["chung_lu"])
    # four batches fit the tiny graph's slack
    mix = dict(mix, endpoints="degree", max_batches=4)
    g = graphs.build(config["graph"], 4, "cpu")
    t = Traffic(mix, g, 32, 2 ** 31 + 5, "cpu")
    src, dst = t.batch(3)
    deg = np.bincount(g["src"], minlength=g["num_vertices"])
    assert (deg[src] > 0).all() and (deg[dst] > 0).all()
    assert deg[src].mean() > 2 * deg.mean()        # hubs drawn more often
    assert np.array_equal(src, t.batch(3)[0])
    with pytest.raises(ValueError):
        Traffic(dict(mix, endpoints="zipf"), g, 32, 1, "cpu")
    result, checks = cell_mod.run_cell(name, 2 ** 31 + 5, 0.5, False, "cpu",
                                       time.perf_counter(), config=config,
                                       mix=mix, log=lambda m: None)
    assert result["correct"] and result["attempted"] == 3, checks
