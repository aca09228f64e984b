"""Whole runs of the PyTorch port against the reference, on the CPU.

Labels, loads, iteration counts and the halted flag must be IDENTICAL to
``repro.core.spinner.partition`` for the same seed and padded layout --
for every runner, score backend and fused-update setting -- because the
port draws the reference's threefry streams and keeps its op order.  Only
score(G) and the chunked runner's phi, float32 sums taken in another
order, are compared within rtol=1e-5.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import EngineOptions as RefOptions
from repro.core import SpinnerConfig as RefConfig
from repro.core import engine as ref_engine
from repro.core import generators as ref_gen
from repro.core import graph as ref_graph
from repro.core import partition as ref_partition
from repro.core.spinner import prepare_init as ref_prepare_init
from repro_torch.convert import graph_from_reference, state_from_reference
from repro_torch.core import (EngineOptions, SpinnerConfig, engine,
                              generators, partition)
from repro_torch.core import graph as port_graph
from repro_torch.core.spinner import prepare_init

REPO = Path(__file__).resolve().parents[1]
GRAPHS = ["small_world", "clustered", "powerlaw"]
CFG = dict(k=8, seed=3)
PORT_VARIANTS = [("cuda", "auto"), ("cuda", "off"), ("torch", "auto"),
                 ("torch", "on")]


def _same(port, ref):
    np.testing.assert_array_equal(port.labels, np.asarray(ref.labels))
    np.testing.assert_array_equal(port.loads, np.asarray(ref.loads))
    assert port.iterations == ref.iterations
    assert port.halted == ref.halted


def _same_history(port, ref):
    assert len(port.history) == len(ref.history) == port.iterations
    for a, b in zip(port.history, ref.history):
        assert a["iteration"] == b["iteration"]
        assert a["migrations"] == b["migrations"]
        assert a["message_mass"] == b["message_mass"]
        assert a["rho"] == pytest.approx(b["rho"], rel=1e-6)
        assert a["phi"] == pytest.approx(b["phi"], rel=1e-5)
        assert a["score"] == pytest.approx(b["score"], rel=1e-5)


@pytest.fixture(scope="module")
def ref_runs():
    """Reference results, computed once per (graph, engine)."""
    return {}


def _ref_run(ref_runs, request, name, eng):
    key = (name, eng)
    if key not in ref_runs:
        g = request.getfixturevalue(name)
        ref_runs[key] = ref_partition(
            g, RefConfig(**CFG), engine=eng,
            record_history=False if eng == "fused" else None)
    return ref_runs[key]


@pytest.mark.parametrize("backend,fused", PORT_VARIANTS)
@pytest.mark.parametrize("name", GRAPHS)
def test_fused_matches_reference(ref_runs, request, name, backend, fused):
    ref = _ref_run(ref_runs, request, name, "fused")
    g = graph_from_reference(request.getfixturevalue(name))
    res = partition(g, SpinnerConfig(**CFG), engine="fused",
                    record_history=False,
                    options=EngineOptions(device="cpu", score_backend=backend,
                                          fused_update=fused))
    _same(res, ref)
    assert res.history == [] and res.engine == "fused"
    assert res.total_messages == ref.total_messages


@pytest.mark.parametrize("name", GRAPHS)
def test_host_matches_reference(ref_runs, request, name):
    ref = _ref_run(ref_runs, request, name, "host")
    g = graph_from_reference(request.getfixturevalue(name))
    res = partition(g, SpinnerConfig(**CFG), engine="host", device="cpu")
    _same(res, ref)
    _same_history(res, ref)
    assert res.total_messages == ref.total_messages


@pytest.mark.parametrize("name", GRAPHS)
def test_chunked_matches_reference(request, name):
    rg = request.getfixturevalue(name)
    cfg = dict(CFG, max_iters=40)
    ref = ref_partition(rg, RefConfig(**cfg), engine="chunked",
                        chunk_size=16)
    seen = []
    res = partition(graph_from_reference(rg), SpinnerConfig(**cfg),
                    engine="chunked", chunk_size=16, device="cpu",
                    callback=lambda it, e: seen.append(it))
    _same(res, ref)
    _same_history(res, ref)
    assert seen == [e["iteration"] for e in res.history]


def test_pallas_reference_once():
    """The reference's Pallas megakernel (interpret mode) walks the same
    trajectory as the port's fused CSR kernel path."""
    rg = ref_gen.watts_strogatz(300, 6, 0.2, seed=3)
    cfg = dict(k=5, seed=7)
    ref = ref_partition(rg, RefConfig(**cfg), record_history=False,
                        options=RefOptions(score_backend="pallas",
                                           autotune="off"))
    res = partition(graph_from_reference(rg), SpinnerConfig(**cfg),
                    record_history=False, device="cpu")
    _same(res, ref)


@pytest.mark.parametrize("chunk,max_iters,window", [
    (3, 7, 5), (32, 1, 5), (2, 300, 5), (32, 300, 1), (4, 300, 0),
    (32, 0, 5)])
def test_chunk_planning_keeps_iteration_counts(small_world, chunk,
                                               max_iters, window):
    cfg = dict(k=6, seed=11, max_iters=max_iters, halt_window=window)
    ref = ref_partition(small_world, RefConfig(**cfg), engine="fused",
                        record_history=False)
    res = partition(graph_from_reference(small_world), SpinnerConfig(**cfg),
                    engine="fused", chunk_size=chunk, record_history=False,
                    device="cpu")
    _same(res, ref)


def test_init_with_new_vertices(clustered):
    rng = np.random.default_rng(4)
    init = rng.integers(0, 8, clustered.num_vertices).astype(np.int32)
    init[rng.random(init.shape[0]) < 0.2] = -1
    ref = ref_partition(clustered, RefConfig(**CFG), init=init,
                        engine="fused", record_history=False)
    res = partition(graph_from_reference(clustered), SpinnerConfig(**CFG),
                    init=init, engine="fused", record_history=False,
                    device="cpu")
    _same(res, ref)


@pytest.mark.parametrize("weighting", ["edges", "vertices"])
def test_unpadded_layout(powerlaw, weighting):
    cfg = dict(CFG, migration_weighting=weighting)
    ref = ref_partition(powerlaw, RefConfig(**cfg), engine="fused",
                        record_history=False,
                        options=RefOptions(pad="none"))
    res = partition(graph_from_reference(powerlaw), SpinnerConfig(**cfg),
                    engine="fused", record_history=False,
                    options=EngineOptions(device="cpu", pad="none"))
    _same(res, ref)


@pytest.mark.parametrize("backend,fused", PORT_VARIANTS)
def test_one_step_bitwise(small_world, backend, fused):
    """One state transition from the same state and key."""
    rcfg = RefConfig(k=7, seed=5)
    labels, loads, key = ref_prepare_init(small_world, rcfg)
    ref = ref_engine.make_step_fn(small_world, rcfg)(
        ref_engine.init_state(labels, loads, key))
    g = graph_from_reference(small_world)
    opts = EngineOptions(device="cpu", pad="none", score_backend=backend,
                         fused_update=fused)
    cfg = SpinnerConfig(k=7, seed=5)
    t_labels, t_loads, t_key = prepare_init(g, cfg, device="cpu")
    assert t_key == tuple(int(x) for x in np.asarray(key))
    np.testing.assert_array_equal(t_labels.numpy(), np.asarray(labels))
    np.testing.assert_array_equal(t_loads.numpy(), np.asarray(loads))
    bind, _ = engine.make_bind(g, cfg, opts, "cpu")
    out = engine.make_step(cfg, opts)(
        engine.init_state(t_labels, t_loads, t_key), bind)
    assert out.key == tuple(int(x) for x in np.asarray(ref.key))
    for f in ("labels", "loads", "stall", "iteration", "halted",
              "migrations", "message_mass", "total_messages"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    assert float(out.score) == pytest.approx(float(ref.score), rel=1e-5)


def test_carry_across_from_reference(small_world):
    """Five reference iterations, then the rest in the port and in the
    reference from the same state: identical continuations."""
    cfg5, cfg = RefConfig(k=6, seed=2, max_iters=5), RefConfig(k=6, seed=2)
    labels, loads, key = ref_prepare_init(small_world, cfg5)
    s5 = ref_engine.make_fused_runner(small_world, cfg5)(
        ref_engine.init_state(labels, loads, key))
    ref = ref_engine.make_fused_runner(small_world, cfg)(s5)
    state = state_from_reference(jax.device_get(s5), device="cpu")
    assert int(state.iteration) == 5
    g = graph_from_reference(small_world)
    out = engine.make_fused_runner(g, SpinnerConfig(k=6, seed=2),
                                   EngineOptions(device="cpu"))(state)
    np.testing.assert_array_equal(out.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(out.loads.numpy(), np.asarray(ref.loads))
    assert int(out.iteration) == int(ref.iteration) > 5
    assert bool(out.halted) == bool(ref.halted)
    assert out.key == tuple(int(x) for x in np.asarray(ref.key))


def test_state_from_export_dict(small_world):
    """A session's ``export_state()`` dict carries labels, loads and key."""
    from repro.core.session import PartitionSession
    with PartitionSession(small_world, RefConfig(k=4, seed=1)) as s:
        s.partition(record_history=False)
        exported = s.export_state()
    state = state_from_reference(exported, device="cpu")
    np.testing.assert_array_equal(state.labels.numpy(), exported["labels"])
    np.testing.assert_array_equal(state.loads.numpy(), exported["loads"])
    assert state.key == (0, 1) and int(state.iteration) == 0


@pytest.fixture(scope="module")
def halved_runs():
    """``watts_strogatz(600, 8, 0.2, seed=3)`` built by each package, its
    Eq. 3 weights halved through each package's ``_finish`` (weights 0.5
    and 1: not integers, but every sum of them is exact in float32), and
    the reference's XLA run on it at k = 6."""
    def halve(finish, g):
        return finish(g.src, g.dst, 0.5 * g.weight, g.num_vertices)

    ref_g = halve(ref_graph._finish, ref_gen.watts_strogatz(600, 8, 0.2,
                                                             seed=3))
    port_g = halve(port_graph._finish, generators.watts_strogatz(
        600, 8, 0.2, seed=3))
    np.testing.assert_array_equal(port_g.weight, ref_g.weight)
    assert not np.all(port_g.deg_w == np.round(port_g.deg_w))
    ref = ref_partition(ref_g, RefConfig(k=6, seed=3), engine="fused",
                        record_history=False,
                        options=RefOptions(score_backend="xla"))
    return port_g, ref


@pytest.mark.parametrize("backend,fused", PORT_VARIANTS)
def test_halved_weights_match_reference(halved_runs, backend, fused):
    """A graph whose weights are not integers: the port's run on the CPU
    (the cuda backend's wrappers run their plain versions there) walks the
    reference's trajectory label for label.  The kernels themselves are
    held to those plain versions on such weights by the card tests."""
    g, ref = halved_runs
    res = partition(g, SpinnerConfig(k=6, seed=3), engine="fused",
                    record_history=False,
                    options=EngineOptions(device="cpu", score_backend=backend,
                                          fused_update=fused))
    _same(res, ref)
    assert res.iterations > 1


def test_imports_neither_jax_nor_reference():
    """The port (its application layer, session, mesh, exchange plans,
    sharded layout, distributed PageRank and placement too) and
    chip_smoke.py load without JAX or ``repro``."""
    code = (
        "import sys; sys.path.insert(0, 'src'); sys.path.insert(0, '.')\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.apps, repro_torch.core.pregel\n"
        "import repro_torch.core.session, repro_torch.core.delta\n"
        "import repro_torch.core.incremental, repro_torch.launch.mesh\n"
        "import repro_torch.core.comm, repro_torch.core.distributed\n"
        "import repro_torch.core.pregel_dist, repro_torch.core.placement\n"
        "import repro_torch.convert, repro_torch.rng, chip_smoke\n"
        "import repro_torch.serve, repro_torch.ckpt, repro_torch.runtime\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    sources = list((REPO / "src" / "repro_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "repro"), (path, line)


def test_no_card_raises_instead_of_falling_back(small_world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = graph_from_reference(small_world)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition(g, SpinnerConfig(k=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition(g, SpinnerConfig(k=4), device="cuda")


def test_runners_run_on_the_options_device(small_world, monkeypatch):
    """The exported runners take host arrays to the options' device: with
    no card they raise, and a state elsewhere is refused, never run."""
    g = graph_from_reference(small_world)
    cfg = SpinnerConfig(k=4, seed=1)
    labels, loads, key = prepare_init(g, cfg, device="cpu")
    labels_np, loads_np = labels.numpy(), loads.numpy()
    want = partition(g, cfg, engine="fused", record_history=False,
                     device="cpu")
    cpu = EngineOptions(device="cpu")
    out = engine.run_fused(g, cfg, labels_np, loads_np, key, cpu)
    np.testing.assert_array_equal(out.labels.numpy(), want.labels)
    assert int(out.iteration) == want.iterations
    out, hist = engine.run_chunked(g, cfg, labels_np, loads_np, key, cpu)
    np.testing.assert_array_equal(out.labels.numpy(), want.labels)
    assert len(hist) == want.iterations

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for opts in (EngineOptions(), EngineOptions(device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.run_fused(g, cfg, labels_np, loads_np, key, opts)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.run_chunked(g, cfg, labels_np, loads_np, key, opts)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.make_fused_runner(g, cfg, opts)
    # a CPU state handed to a runner asked for the card is refused
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    runner = engine.make_fused_runner(g, cfg, EngineOptions())
    with pytest.raises(ValueError, match="options ask for cuda"):
        runner(engine.init_state(labels_np, loads_np, key, device="cpu"))


def test_unported_options_raise(small_world):
    """The sharded knobs are accepted and resolve as the reference's do;
    unknown values raise, as they do there."""
    g = graph_from_reference(small_world)
    for kw in (dict(label_exchange="halo"), dict(delta_cap=8),
               dict(sharded_noise="folded"), dict(overlap="on")):
        opts, ref_opts = EngineOptions(device="cpu", **kw), RefOptions(**kw)
        for ndev in (1, 2, 4):
            assert opts.resolved_label_exchange(ndev) \
                == ref_opts.resolved_label_exchange(ndev)
            assert opts.resolved_overlap(ndev) \
                == ref_opts.resolved_overlap(ndev)
        assert opts.resolved_sharded_noise() \
            == ref_opts.resolved_sharded_noise()
    for bad in ("onn", "yes"):
        with pytest.raises(ValueError, match="unknown overlap"):
            EngineOptions(device="cpu", overlap=bad)
    with pytest.raises(ValueError, match="unknown label_exchange"):
        EngineOptions(device="cpu",
                      label_exchange="bogus").resolved_label_exchange(2)
    with pytest.raises(ValueError, match="unknown sharded_noise"):
        EngineOptions(device="cpu",
                      sharded_noise="bogus").resolved_sharded_noise()
    EngineOptions(device="cpu", overlap="off")
    cfg = SpinnerConfig(k=4, max_iters=30)
    sharded = partition(g, cfg, engine="sharded", device="cpu")
    fused = partition(g, cfg, engine="fused", device="cpu")
    np.testing.assert_array_equal(sharded.labels, fused.labels)
    assert sharded.iterations == fused.iterations
    with pytest.raises(ValueError):
        partition(g, SpinnerConfig(k=4), engine="fused", device="cpu",
                  record_history=True)
    with pytest.raises(ValueError):
        partition(g, SpinnerConfig(k=4), engine="bogus", device="cpu")
