"""Durability in the port: checkpoints, the train supervisor, and a
session's ``export_state`` / ``import_state``, against the reference.

* ``repro_torch.ckpt.checkpoint``: the round trip (tensors and arrays,
  dicts, lists, tuples, NamedTuples), ``latest_step`` / ``gc_old``, no
  visible step after a crash between the tmp write and the rename, and
  the same tree saved by both packages giving the same keys and equal
  ``.npy`` arrays (the manifests differ in format only: JSON here,
  msgpack in the reference).
* ``repro_torch.runtime``: a crashed and restarted toy torch training run
  ends bit-identical to an uninterrupted one; a slow step is flagged.
* ``PartitionSession.export_state`` equals the reference's for the same
  run, and a fresh session that imports it (straight or through a
  checkpoint) continues with an ``adapt`` identical to the uninterrupted
  session's and to the reference's.
"""
import collections
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_checkpoint
from repro.core import SpinnerConfig as RefConfig
from repro.core import generators as ref_generators
from repro.core import open_session as ref_open
from repro_torch.ckpt import checkpoint
from repro_torch.convert import graph_from_reference, state_from_reference
from repro_torch.core import EngineOptions, SpinnerConfig, open_session
from repro_torch.runtime import SupervisorConfig, TrainSupervisor

Pair = collections.namedtuple("Pair", "second first")
BACKENDS = ["torch", "cuda"]


def _tree(lib):
    """A tree with every container kind, leaves as ``lib`` arrays."""
    arr = (lambda x: torch.as_tensor(x)) if lib == "torch" else np.asarray
    return {"z": [arr(np.arange(6, dtype=np.int32).reshape(2, 3)),
                  (arr(np.float32([2.5])), None)],
            "a": Pair(arr(np.ones(4, np.float32)),
                      {"q": arr(np.int64(7)), "b": arr(np.bool_(True))}),
            "n": None}


def _leaves_equal(a, b):
    if a is None or b is None:
        assert a is b is None
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _leaves_equal(a[k], b[k])
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        assert type(a) is type(b)
        for x, y in zip(a, b):
            _leaves_equal(x, y)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _leaves_equal(x, y)
    else:
        assert type(a) is type(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lib", ["torch", "numpy"])
def test_roundtrip(tmp_path, lib):
    tree = _tree(lib)
    path = checkpoint.save(str(tmp_path), 3, tree)
    assert os.path.basename(path) == "step_00000003"
    _leaves_equal(tree, checkpoint.restore(str(tmp_path), tree))
    on_cpu = checkpoint.restore(str(tmp_path), _tree("numpy"), device="cpu")
    assert isinstance(on_cpu["a"].second, torch.Tensor)
    _leaves_equal(_tree("torch"), on_cpu)


def test_restore_checks_shapes(tmp_path):
    checkpoint.save(str(tmp_path), 0, {"x": np.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), {"x": np.zeros(3)})
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "empty"), {"x": np.zeros(2)})


def test_latest_and_gc(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (1, 5, 9):
        checkpoint.save(str(tmp_path), s, tree)
    assert checkpoint.latest_step(str(tmp_path)) == 9
    checkpoint.gc_old(str(tmp_path), keep=2)
    assert checkpoint.latest_step(str(tmp_path)) == 9
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000009"]
    assert checkpoint.latest_step(str(tmp_path / "none")) is None


def test_atomic_no_partial(tmp_path, monkeypatch):
    """A crash between the tmp write and the rename leaves no visible step;
    a stale tmp dir is skipped by readers and swept by a writer."""
    tree = {"x": torch.zeros(2)}
    checkpoint.save(str(tmp_path), 1, tree)

    def crash(src, dst):
        raise OSError("killed before the rename")

    monkeypatch.setattr(checkpoint.os, "rename", crash)
    with pytest.raises(OSError):
        checkpoint.save(str(tmp_path), 2, {"x": torch.ones(2)})
    monkeypatch.undo()
    assert os.path.isdir(tmp_path / "step_00000002.tmp")
    assert checkpoint.latest_step(str(tmp_path)) == 1
    _leaves_equal(tree, checkpoint.restore(str(tmp_path), tree))
    checkpoint.gc_old(str(tmp_path), keep=3, tmp_age=0.0)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]


def test_same_files_as_the_reference(tmp_path):
    """The same tree saved by both packages: the same leaf keys in the same
    order, the same file names, equal arrays of equal dtypes."""
    tree = _tree("numpy")
    ref_checkpoint.save(str(tmp_path / "ref"), 4, tree)
    checkpoint.save(str(tmp_path / "port"), 4, _tree("torch"))
    ref_dir, port_dir = (tmp_path / d / "step_00000004"
                         for d in ("ref", "port"))
    import msgpack
    with open(ref_dir / "manifest.msgpack", "rb") as f:
        want = msgpack.unpackb(f.read())
    with open(port_dir / "manifest.json") as f:
        got = json.load(f)
    assert got == want
    assert [e["key"] for e in got["keys"]] == [
        "a/.second", "a/.first/b", "a/.first/q", "z/0", "z/1/0"]
    files = sorted(os.listdir(port_dir))
    assert files == sorted(set(os.listdir(ref_dir)) - {"manifest.msgpack"}
                           | {"manifest.json"})
    for name in files:
        if name.endswith(".npy"):
            a, b = np.load(port_dir / name), np.load(ref_dir / name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_restore_into_namedtuple_state(tmp_path):
    state = Pair(second={"w": torch.ones(3, 3)}, first=torch.tensor(0))
    checkpoint.save(str(tmp_path), 0, state)
    restored = checkpoint.restore(str(tmp_path), state)
    assert isinstance(restored, Pair)
    _leaves_equal(state, restored)


# ---------------------------------------------------------------------------
# the train supervisor on a toy torch training step
# ---------------------------------------------------------------------------

def _train_step(state, batch):
    """One SGD step of a least-squares fit (float32, deterministic)."""
    x, y = batch
    w = state["w"]
    grad = 2.0 * x.T @ (x @ w - y) / x.shape[0]
    return {"w": w - 0.05 * grad, "step": state["step"] + 1}, {}


def _batch(step):
    gen = torch.Generator().manual_seed(1000 + step)
    x = torch.randn(16, 4, generator=gen)
    return x, x @ torch.arange(1.0, 5.0)[:, None]


def _init():
    return {"w": torch.zeros(4, 1), "step": torch.tensor(0)}


def test_crash_restart_bitexact(tmp_path):
    ref = TrainSupervisor(SupervisorConfig(ckpt_dir=str(tmp_path / "ref"),
                                           ckpt_every=4), _init())
    final_ref = ref.run(_train_step, _batch, 10)
    cfg = SupervisorConfig(ckpt_dir=str(tmp_path / "run"), ckpt_every=4)
    sup = TrainSupervisor(cfg, _init())
    with pytest.raises(RuntimeError, match="simulated worker failure"):
        sup.run(_train_step, _batch, 10, crash_at=7)
    sup2 = TrainSupervisor(cfg, _init())
    assert sup2.start_step == 4
    assert int(sup2.state["step"]) == 4
    final = sup2.run(_train_step, _batch, 10)
    assert torch.equal(final["w"], final_ref["w"])
    assert int(final["step"]) == 10
    assert checkpoint.latest_step(cfg.ckpt_dir) == 10
    assert sup2.stats()["start_step"] == 4 and sup2.stats()["steps"] == 6


def test_straggler_flagging(tmp_path):
    sup = TrainSupervisor(SupervisorConfig(
        ckpt_dir=str(tmp_path / "s"), ckpt_every=100, straggler_factor=2.0),
        _init())
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 9:
            time.sleep(0.2)          # one pathological step
        return _train_step(state, batch)

    sup.run(slow_step, _batch, 10)
    st = sup.stats()
    assert 8 in [s for s, _, _ in st["flagged_steps"]]
    assert st["steps"] == 10 and st["straggler_factor"] == 2.0


# ---------------------------------------------------------------------------
# a session's export_state / import_state
# ---------------------------------------------------------------------------

CFG = dict(k=6, max_iters=90, seed=5)


@pytest.fixture(scope="module")
def rgraph():
    return ref_generators.watts_strogatz(700, 8, 0.1, seed=3)


def _batches(v):
    rng = np.random.default_rng(8)
    return [(rng.integers(0, v, 20), rng.integers(0, v, 20))
            for _ in range(2)]


def _opts(backend):
    return EngineOptions(device="cpu", score_backend=backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_export_state_matches_reference(rgraph, backend):
    b1, _ = _batches(rgraph.num_vertices)
    ref = ref_open(rgraph, RefConfig(**CFG))
    ref.partition(record_history=False)
    ref.adapt(edge_updates=b1, record_history=False)
    port = open_session(graph_from_reference(rgraph), SpinnerConfig(**CFG),
                        _opts(backend))
    port.partition(record_history=False)
    port.adapt(edge_updates=b1, record_history=False)
    got, want = port.export_state(), ref.export_state()
    assert list(got) == list(want)
    for key in want:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), key)
    # convert.py reads both packages' dicts
    for d in (got, want):
        s = state_from_reference(d, "cpu")
        assert s.key == (0, CFG["seed"])
        np.testing.assert_array_equal(s.labels.numpy(), got["labels"])


def test_export_state_before_a_run_raises(rgraph):
    s = open_session(graph_from_reference(rgraph), SpinnerConfig(**CFG),
                     _opts("torch"))
    with pytest.raises(ValueError, match="no stable labels"):
        s.export_state()


@pytest.mark.parametrize("through_checkpoint", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_import_then_adapt_continues(tmp_path, rgraph, backend,
                                     through_checkpoint):
    """export_state (optionally saved and restored), import_state into a
    freshly opened session on the same logical graph, then the next
    adapt: identical to the uninterrupted session's and to the
    reference's after its own import."""
    b1, b2 = _batches(rgraph.num_vertices)
    g = graph_from_reference(rgraph)
    live = open_session(g, SpinnerConfig(**CFG), _opts(backend))
    live.partition(record_history=False)
    live.adapt(edge_updates=b1, record_history=False)
    snap, g_b1 = live.export_state(), live.graph
    if through_checkpoint:
        checkpoint.save(str(tmp_path), 1, snap)
        snap = checkpoint.restore(str(tmp_path), snap)
    want = live.adapt(edge_updates=b2, record_history=False)

    fresh = open_session(g_b1, SpinnerConfig(**CFG), _opts(backend))
    got = fresh.import_state(snap).adapt(edge_updates=b2,
                                         record_history=False)
    ref = ref_open(rgraph, RefConfig(**CFG))
    ref.partition(record_history=False)
    ref.adapt(edge_updates=b1, record_history=False)
    rfresh = ref_open(ref.graph, RefConfig(**CFG))
    rgot = rfresh.import_state(ref.export_state()).adapt(
        edge_updates=b2, record_history=False)
    for other in (want, rgot):
        np.testing.assert_array_equal(got.labels, np.asarray(other.labels))
        np.testing.assert_array_equal(got.loads, np.asarray(other.loads))
        assert (got.iterations, got.halted) == (other.iterations,
                                                other.halted)
    st = fresh.stats()
    assert st["runs"] == int(snap["runs"]) + 1
    assert st["delta"]["watermark"] == int(snap["delta_watermark"]) + 1


def test_import_state_refuses_a_mismatch(rgraph):
    s = open_session(graph_from_reference(rgraph), SpinnerConfig(**CFG),
                     _opts("torch"))
    s.partition(record_history=False)
    snap = s.export_state()
    other_k = open_session(graph_from_reference(rgraph),
                           SpinnerConfig(**dict(CFG, k=7)), _opts("torch"))
    with pytest.raises(ValueError, match="k=6"):
        other_k.import_state(snap)
    small = open_session(graph_from_reference(
        ref_generators.watts_strogatz(300, 8, 0.1, seed=3)),
        SpinnerConfig(**CFG), _opts("torch"))
    with pytest.raises(ValueError, match="700 labels"):
        small.import_state(snap)
