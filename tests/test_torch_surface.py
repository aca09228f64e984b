"""The public surface the port's ported modules gained to match the
reference's: ``Graph.num_undirected_edges`` / ``validate``, the
``SpinnerConfig`` deprecation shim (``SpinnerDeprecationWarning``,
``resolve_options``: the reference's ``TestConfigSplitShim`` in
``tests/test_session.py``), ``metrics.summarize(sg=)``, and
``repro_torch.core``'s re-exports (``make_step`` with the reference's
``(graph, cfg)`` signature).  Each is held to the reference on the same
inputs.
"""
import warnings

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as core
from repro.core import distributed as ref_distributed
from repro.core import generators as ref_generators
from repro_torch import rng
from repro_torch.core import (EngineOptions, SpinnerConfig,
                              SpinnerDeprecationWarning, generators, metrics,
                              partition, resolve_options)
from repro_torch.core import distributed

# the reference's TPU-only names, recorded in the README and not ported
TPU_ONLY = {"TiledCSR", "build_tiled_csr", "make_chunked_runner",
            "make_iteration", "make_step_fn"}
CPU = EngineOptions(device="cpu")


@pytest.fixture(scope="module")
def ws_graph():
    return generators.watts_strogatz(1500, 8, 0.2, seed=3)


# ---------------------------------------------------------------------------
# the SpinnerConfig shim (tests/test_session.py TestConfigSplitShim)
# ---------------------------------------------------------------------------

class TestConfigSplitShim:
    def test_use_kernel_warns_and_resolves(self):
        with pytest.warns(SpinnerDeprecationWarning, match="use_kernel"):
            cfg = SpinnerConfig(k=4, use_kernel=True)
        cfg2, opts = resolve_options(cfg)
        assert opts.score_backend == "cuda"
        assert cfg2.use_kernel is False          # scrubbed downstream

    @pytest.mark.parametrize("legacy,backend", [("pallas", "cuda"),
                                                ("xla", "torch")])
    def test_engine_knobs_warn_and_resolve(self, legacy, backend):
        with pytest.warns(SpinnerDeprecationWarning,
                          match="label_exchange"):
            cfg = SpinnerConfig(k=4, label_exchange="halo", delta_cap=9,
                                sharded_noise="folded",
                                score_backend=legacy)
        cfg2, opts = resolve_options(cfg)
        assert opts.label_exchange == "halo"
        assert opts.delta_cap == 9
        assert opts.sharded_noise == "folded"
        assert opts.score_backend == backend
        assert cfg2.score_backend is None and cfg2.label_exchange is None

    def test_clean_config_does_not_warn(self):
        with warnings.catch_warnings():
            warnings.simplefilter("error", SpinnerDeprecationWarning)
            cfg = SpinnerConfig(k=4, c=1.1, eps=1e-4, seed=3)
            resolve_options(cfg, EngineOptions(score_backend="torch"))
        # options set explicitly win over the deprecated fields
        with pytest.warns(SpinnerDeprecationWarning):
            old = SpinnerConfig(k=4, score_backend="xla", delta_cap=3)
        _, opts = resolve_options(old, EngineOptions(score_backend="cuda",
                                                     delta_cap=5))
        assert opts.delta_cap == 5

    def test_legacy_config_still_runs_identically(self, ws_graph):
        """The shim preserves behaviour: ``score_backend="xla"`` equals
        the ``EngineOptions(score_backend="torch")`` spelling bit for bit,
        through ``partition`` and through a session, and both equal the
        reference's legacy run."""
        with pytest.warns(SpinnerDeprecationWarning):
            cfg_old = SpinnerConfig(k=4, seed=2, max_iters=20,
                                    score_backend="xla")
        cfg_new = SpinnerConfig(k=4, seed=2, max_iters=20)
        a = partition(ws_graph, cfg_old, record_history=False, device="cpu")
        b = partition(ws_graph, cfg_new, record_history=False,
                      options=EngineOptions(device="cpu",
                                            score_backend="torch"))
        with core.open_session(ws_graph, cfg_old, CPU) as s:
            c = s.partition(record_history=False)
            assert s.cfg.score_backend is None
            assert s.options.score_backend == "torch"
        with pytest.warns(ref_core.SpinnerDeprecationWarning):
            ref_cfg = ref_core.SpinnerConfig(k=4, seed=2, max_iters=20,
                                             score_backend="xla")
        ref = ref_core.partition(_ref_graph(ws_graph), ref_cfg,
                                 record_history=False)
        for r in (b, c, ref):
            np.testing.assert_array_equal(a.labels, r.labels)
            np.testing.assert_array_equal(a.loads, r.loads)
            assert a.iterations == r.iterations


def _ref_graph(g):
    """The reference Graph with the port graph's arrays."""
    return ref_core.Graph(num_vertices=g.num_vertices, src=g.src, dst=g.dst,
                          weight=g.weight, row_ptr=g.row_ptr, deg_w=g.deg_w)


# ---------------------------------------------------------------------------
# Graph.num_undirected_edges / validate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda gen: gen.watts_strogatz(400, 6, 0.3, seed=1),
    lambda gen: gen.powerlaw_ba(300, 4, seed=2),
    lambda gen: gen.grid_2d(7, 9)])
def test_graph_counts_and_validate_match_reference(make):
    g, ref = make(generators), make(ref_generators)
    assert g.num_undirected_edges == ref.num_undirected_edges
    assert g.num_undirected_edges * 2 == g.num_directed_entries
    g.validate()
    ref.validate()


def test_validate_refuses_what_the_reference_refuses():
    g = generators.watts_strogatz(200, 4, 0.1, seed=5)
    one_way = core.Graph(num_vertices=g.num_vertices, src=g.src[:-1],
                         dst=g.dst[:-1], weight=g.weight[:-1],
                         row_ptr=np.minimum(g.row_ptr,
                                            g.num_directed_entries - 1),
                         deg_w=g.deg_w)
    with pytest.raises(ValueError, match="symmetric"):
        one_way.validate()
    with pytest.raises(AssertionError):
        _ref_graph(one_way).validate()
    short = core.Graph(num_vertices=g.num_vertices + 1, src=g.src,
                       dst=g.dst, weight=g.weight, row_ptr=g.row_ptr,
                       deg_w=g.deg_w)
    with pytest.raises(ValueError, match="row_ptr"):
        short.validate()


# ---------------------------------------------------------------------------
# summarize(sg=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev,pad", [(1, False), (4, True)])
def test_summarize_with_layout_matches_reference(ndev, pad):
    g = generators.watts_strogatz(600, 8, 0.2, seed=4)
    labels = np.random.default_rng(ndev).integers(0, 5, g.num_vertices)
    ref_g = _ref_graph(g)
    got = metrics.summarize(g, labels, 5, sg=distributed.shard_graph(
        g, ndev, pad=pad))
    want = ref_core.metrics.summarize(ref_g, labels, 5,
                                      sg=ref_distributed.shard_graph(
                                          ref_g, ndev, pad=pad))
    assert got == want
    assert "frontier_fraction" in got
    assert "frontier_fraction" not in metrics.summarize(g, labels, 5)


# ---------------------------------------------------------------------------
# re-exports
# ---------------------------------------------------------------------------

def test_core_exports_every_reference_name_but_the_tpu_only_ones():
    missing = set(ref_core.__all__) - set(core.__all__)
    assert missing == TPU_ONLY
    for name in core.__all__:
        assert hasattr(core, name), name


def test_make_step_takes_the_reference_signature(ws_graph):
    """``make_step(graph, cfg)`` is one iteration on the graph's exact
    shapes: from the same labels, loads and key, the reference's."""
    cfg = SpinnerConfig(k=5, seed=7)
    labels, loads, key = core.prepare_init(ws_graph, cfg, device="cpu")
    it_key = rng.split(key)[1]
    out = core.make_step(ws_graph, cfg, device="cpu")(labels, loads, it_key)
    import jax.numpy as jnp
    ref_cfg = ref_core.SpinnerConfig(k=5, seed=7)
    ref_step = ref_core.make_step(_ref_graph(ws_graph), ref_cfg)
    ref_out = ref_step(jnp.asarray(labels.numpy()),
                       jnp.asarray(loads.numpy()),
                       jnp.asarray(np.asarray(it_key, np.uint32)))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref_out[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref_out[1]))
    np.testing.assert_allclose(float(out[2]), float(ref_out[2]), rtol=1e-5)
    assert int(out[3]) == int(ref_out[3])
