"""The port's optimizer, data, train steps and LLM entry points against the
reference's on the CPU.

* AdamW: ``schedule`` and three ``update`` steps against
  ``repro.optim.adamw`` (rtol 1e-6), the clip, convergence on a quadratic;
* ``compression`` and ``pipeline`` (``batch_at``, ``stream``,
  ``for_model``, ``frontend_stub``): the reference's bits;
* train steps from carried weights: five steps of reduced stablelm-1.6b
  (losses within rtol 5e-3 of the reference's), the ``microbatch`` and
  ``bf16_grads`` variants (``tests/test_perf_variants.py``), the loss
  decreasing and the checkpoint restart bit-exact
  (``tests/test_train_loop.py``), the supervisor's crash restart
  (``tests/test_runtime.py``), a reference ``TrainState`` checkpoint
  restored by ``repro_torch.ckpt`` continuing the reference's run;
* ``launch.serve_llm`` (every family, with ``--check``), its serving
  copy drawn leaf by leaf, ``launch.train`` (encdec and vlm on the
  frontend stub too) and ``examples/torch_train_lm.py`` small on
  ``--device cpu``; every entry point raises without a card.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_checkpoint
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.data import pipeline as ref_pipeline
from repro.models import build as ref_build
from repro.models import init_params as ref_init
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_compression
from repro.train import steps as ref_steps
from repro_torch.ckpt import checkpoint
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.convert import (params_from_reference,
                                 train_state_from_reference)
from repro_torch.data import pipeline
from repro_torch.launch import serve_llm, train
from repro_torch.models import build
from repro_torch.models import common
from repro_torch.models.common import tree_leaves_with_path
from repro_torch.optim import adamw, compression
from repro_torch.runtime import SupervisorConfig, TrainSupervisor
from repro_torch.train import steps

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six
    workers on the CPU, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves(tree):
    return [_np(x) for _, x in tree_leaves_with_path(tree)]


def _ref_leaves(tree):
    return [_np(x) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# AdamW

@pytest.mark.parametrize("cfg", [
    adamw.AdamWConfig(),
    adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1),
    adamw.AdamWConfig(lr=6e-4, warmup_steps=0, total_steps=7),
])
def test_schedule_matches_reference(cfg):
    ref_cfg = ref_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 10, 55, 99, 100, 150, 10_000):
        got = float(adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(ref_adamw.schedule(ref_cfg, jnp.int32(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def _tree_of(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def test_adamw_update_matches_reference():
    """Three updates (the clip active on the first) against the
    reference's: params, m, v, grad norm and lr within rtol 1e-6 (an
    element of m or v also within 1e-6 of its tensor's largest magnitude:
    the global norm sums in another order, and an ulp of the clip scale
    survives a cancellation in the moments)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5, 7), "c": (11,), "d": (4, 4)}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            weight_decay=0.1)
    rcfg = ref_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    p0 = _tree_of(rng, shapes)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rs, ps = ref_adamw.init(rp), adamw.init(pp)
    for i, scale in enumerate((5.0, 0.1, 0.3)):
        g = _tree_of(rng, shapes, scale)
        rp, rs, rst = ref_adamw.update(
            rcfg, {k: jnp.asarray(v) for k, v in g.items()}, rs, rp)
        pp, ps, pst = adamw.update(
            cfg, {k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
        assert int(ps.step) == int(rs.step) == i + 1
        for key in ("grad_norm", "lr"):
            assert float(pst[key]) == pytest.approx(float(rst[key]),
                                                    rel=1e-6)
        for got, want in ((pp, rp), (ps.m, rs.m), (ps.v, rs.v)):
            for k in shapes:
                w = _np(want[k])
                np.testing.assert_allclose(_np(got[k]), w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max())


def test_adamw_clip_caps_update():
    cfg = adamw.AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    state = adamw.init(params)
    _, state2, stats = adamw.update(cfg, {"w": torch.full((4,), 100.0)},
                                    state, params)
    assert float(stats["grad_norm"]) == pytest.approx(200.0)
    assert float(state2.m["w"].abs().max()) < 0.2


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=5,
                            total_steps=200)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)
    for _ in range(150):
        params, state, _ = adamw.update(cfg, {"w": 2 * params["w"]}, state,
                                        params)
    assert float(params["w"].abs().max()) < 0.05


# ---------------------------------------------------------------------------
# compression and data: the reference's bits

def test_compression_matches_reference():
    rng = np.random.default_rng(1)
    for n in (1, 255, 256, 1000, 3 * 256 + 17):
        x = (rng.standard_normal(n) * 10 ** rng.uniform(-3, 1)).astype(
            np.float32)
        c, rc = compression.compress(torch.from_numpy(x)), \
            ref_compression.compress(jnp.asarray(x))
        np.testing.assert_array_equal(c.q.numpy(), np.asarray(rc.q))
        np.testing.assert_array_equal(c.scale.numpy(), np.asarray(rc.scale))
        assert c.n == rc.n
        np.testing.assert_array_equal(
            compression.decompress(c, (n,)).numpy(),
            np.asarray(ref_compression.decompress(rc, (n,))))
    g = {"a": rng.standard_normal((10, 30)).astype(np.float32),
         "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    tg = {"a": torch.from_numpy(g["a"]), "b": {"c": torch.from_numpy(
        g["b"]["c"])}}
    jg = jax.tree.map(jnp.asarray, g)
    err, rerr = None, None
    for _ in range(3):
        comp, err = compression.compress_tree(tg, err)
        rcomp, rerr = ref_compression.compress_tree(jg, rerr)
        for a, b in zip(_leaves(err), _ref_leaves(rerr)):
            np.testing.assert_array_equal(a, b)
        out = compression.decompress_tree(comp, tg)
        rout = ref_compression.decompress_tree(rcomp, jg)
        for a, b in zip(_leaves(out), _ref_leaves(rout)):
            np.testing.assert_array_equal(a, b)
        assert compression.wire_bytes(comp) == \
            ref_compression.wire_bytes(rcomp)


def test_compression_error_feedback_unbiased():
    g = {"w": torch.full((300,), 0.01234)}
    errors, applied = None, torch.zeros(300)
    for _ in range(50):
        comp, errors = compression.compress_tree(g, errors)
        applied = applied + compression.decompress_tree(comp, g)["w"]
    np.testing.assert_allclose(applied.numpy(), np.full(300, 50 * 0.01234),
                               rtol=0.02)


@pytest.mark.parametrize("kw", [
    dict(vocab=100, seq_len=32, global_batch=8, seed=3),
    dict(vocab=512, seq_len=64, global_batch=4, seed=1, n_motifs=8),
    dict(vocab=1000, seq_len=17, global_batch=6, noise=0.0, motif_len=5),
])
def test_pipeline_matches_reference(kw):
    cfg, rcfg = pipeline.DataConfig(**kw), ref_pipeline.DataConfig(**kw)
    for step in (0, 1, 7):
        for shards in (1, 2):
            for shard in range(shards):
                a = pipeline.batch_at(cfg, step, shard, shards)
                b = ref_pipeline.batch_at(rcfg, step, shard, shards)
                for key in ("tokens", "labels"):
                    assert a[key].dtype == b[key].dtype == np.int32
                    np.testing.assert_array_equal(a[key], b[key])
    for a, b, _ in zip(pipeline.stream(cfg, 3), ref_pipeline.stream(rcfg, 3),
                       range(3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_for_model_and_frontend_stub_match_reference():
    for arch in sorted(ARCHS):
        for shape, rshape in zip(SHAPES[:1], REF_SHAPES[:1]):
            assert dataclasses.asdict(pipeline.for_model(
                ARCHS[arch], shape, seed=2)) == dataclasses.asdict(
                ref_pipeline.for_model(REF_ARCHS[arch], rshape, seed=2))
        small = dataclasses.replace(SHAPES[0], seq_len=8, global_batch=2)
        rsmall = dataclasses.replace(REF_SHAPES[0], seq_len=8, global_batch=2)
        a = pipeline.frontend_stub(ARCHS[arch].reduced(), small, 3)
        b = ref_pipeline.frontend_stub(REF_ARCHS[arch].reduced(), rsmall, 3)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# train steps

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)


def _data(cfg, seq_len=32, batch=4, seed=2):
    return pipeline.DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                               global_batch=batch, seed=seed)


def _batch(data_cfg, step):
    return {k: torch.from_numpy(v)
            for k, v in pipeline.batch_at(data_cfg, step).items()}


def _ref_run(cfg, opt, rp, data_cfg, n):
    step = jax.jit(ref_steps.make_train_step(ref_build(cfg), opt))
    state = ref_steps.init_train_state(rp)
    out = []
    for i in range(n):
        state, st = step(state, jax.tree.map(
            jnp.asarray, pipeline.batch_at(data_cfg, i)))
        out.append((float(st["loss"]), float(st["grad_norm"])))
    return state, out


def _port_run(cfg, opt, params, data_cfg, n, start=0, state=None):
    step = steps.make_train_step(build(cfg), opt)
    state = state or steps.init_train_state(params)
    out = []
    for i in range(start, start + n):
        state, st = step(state, _batch(data_cfg, i))
        out.append((float(st["loss"]), float(st["grad_norm"])))
    return state, out


@pytest.fixture(scope="module")
def carried():
    """Reduced stablelm-1.6b: the reference's init and its five steps."""
    rcfg = REF_ARCHS["stablelm-1.6b"].reduced()
    rp = ref_init(ref_build(rcfg), jax.random.PRNGKey(0))
    host = jax.device_get(rp)
    ref_state, ref_out = _ref_run(rcfg, ref_adamw.AdamWConfig(**OPT), rp,
                                  _data(rcfg), 5)
    return rcfg, host, ref_state, ref_out


def test_five_train_steps_match_reference(carried):
    rcfg, host, ref_state, ref_out = carried
    cfg = ARCHS["stablelm-1.6b"].reduced()
    state, out = _port_run(cfg, adamw.AdamWConfig(**OPT),
                           params_from_reference(host, "cpu"), _data(cfg), 5)
    for (loss, gn), (rloss, rgn) in zip(out, ref_out):
        assert loss == pytest.approx(rloss, rel=5e-3)
        assert gn == pytest.approx(rgn, rel=2e-2)
    assert int(state.step) == int(state.opt.step) == 5
    # AdamW moves an element with a near-zero gradient by ~lr whatever its
    # sign, so a few elements part ways: each leaf's difference stays
    # within a tenth of the distance both runs travelled
    for a, b, p0 in zip(_leaves(state.params), _ref_leaves(ref_state.params),
                        _ref_leaves(host)):
        assert np.linalg.norm(a - b) <= 0.1 * np.linalg.norm(b - p0) + 1e-7


@pytest.mark.parametrize("knobs", [{"microbatch": 2}, {"bf16_grads": True},
                                   {"ce_chunked": 8, "remat": False}])
def test_train_variants_match_reference(carried, knobs):
    """Each variant's two steps against the reference's same variant, and
    its first loss against the port's baseline step (rel 1e-2, as the
    reference's ``test_microbatch_matches_full_batch``)."""
    rcfg, host, _, ref_out = carried
    rv = dataclasses.replace(rcfg, **knobs)
    cfg = dataclasses.replace(ARCHS["stablelm-1.6b"].reduced(), **knobs)
    _, want = _ref_run(rv, ref_adamw.AdamWConfig(**OPT),
                       jax.tree.map(jnp.asarray, host), _data(rv), 2)
    _, got = _port_run(cfg, adamw.AdamWConfig(**OPT),
                       params_from_reference(host, "cpu"), _data(cfg), 2)
    for (loss, gn), (rloss, rgn) in zip(got, want):
        assert loss == pytest.approx(rloss, rel=5e-3)
        assert gn == pytest.approx(rgn, rel=2e-2)
    assert got[0][0] == pytest.approx(ref_out[0][0], rel=1e-2)
    assert got[0][1] == pytest.approx(ref_out[0][1], rel=2e-2)


@pytest.fixture(scope="module")
def small():
    cfg = ARCHS["stablelm-1.6b"].reduced()
    api = build(cfg)
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=200,
                            weight_decay=0.01)
    data_cfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=64,
                                   global_batch=8, seed=1, n_motifs=8)

    def fresh():
        from repro_torch.models import init_params
        return init_params(api, torch.Generator().manual_seed(0))

    return cfg, api, opt, data_cfg, fresh


def test_loss_decreases(small):
    cfg, api, opt, data_cfg, fresh = small
    state, out = _port_run(cfg, opt, fresh(), data_cfg, 40)
    losses = [loss for loss, _ in out]
    assert losses[-1] < 0.5 * losses[0], losses[::8]
    assert int(state.step) == 40
    ev = steps.make_eval_step(api)
    assert np.isfinite(float(ev(state.params, _batch(data_cfg, 0))))


def test_checkpoint_restart_bitexact(small, tmp_path):
    """Save at step 5, run on; restore and run the same five steps: the same
    losses and params, bit for bit."""
    cfg, api, opt, data_cfg, fresh = small
    state, _ = _port_run(cfg, opt, fresh(), data_cfg, 5)
    checkpoint.save(str(tmp_path), 5, state)
    restored = checkpoint.restore(str(tmp_path), state)
    cont, losses_a = _port_run(cfg, opt, None, data_cfg, 5, 5, state)
    rest, losses_b = _port_run(cfg, opt, None, data_cfg, 5, 5, restored)
    assert losses_a == losses_b
    for a, b in zip(_leaves(cont.params), _leaves(rest.params)):
        np.testing.assert_array_equal(a, b)


def test_supervisor_crash_restart_bitexact(small, tmp_path):
    """``tests/test_runtime.py``'s crash restart on the port: a run killed
    at step 7 and resumed from its step-4 checkpoint ends bit-identical to
    the uninterrupted run; the supervisor times every save."""
    cfg, api, opt, data_cfg, fresh = small
    step = steps.make_train_step(api, opt)
    ref = TrainSupervisor(SupervisorConfig(str(tmp_path / "ref"), 4),
                          steps.init_train_state(fresh()))
    final_ref = ref.run(step, lambda i: _batch(data_cfg, i), 10)
    assert [s for s, _ in ref.saves] == [4, 8, 10]
    sup_cfg = SupervisorConfig(str(tmp_path / "crash"), 4)
    sup = TrainSupervisor(sup_cfg, steps.init_train_state(fresh()))
    with pytest.raises(RuntimeError):
        sup.run(step, lambda i: _batch(data_cfg, i), 10, crash_at=7)
    sup2 = TrainSupervisor(sup_cfg, steps.init_train_state(fresh()))
    assert sup2.start_step == 4
    final = sup2.run(step, lambda i: _batch(data_cfg, i), 10)
    for a, b in zip(_leaves(final_ref), _leaves(final)):
        np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_continues(carried, tmp_path):
    """A reference ``TrainState`` saved by ``repro.ckpt`` after five steps
    restores through ``repro_torch.ckpt`` leaf for leaf (equal to
    ``train_state_from_reference``), and the port's next two steps follow
    the reference's."""
    rcfg, host, ref_state, _ = carried
    ref_checkpoint.save(str(tmp_path), 5, ref_state)
    cfg = ARCHS["stablelm-1.6b"].reduced()
    like = steps.init_train_state(params_from_reference(host, "cpu"))
    restored = checkpoint.restore(str(tmp_path), like)
    carried_state = train_state_from_reference(jax.device_get(ref_state),
                                               "cpu")
    assert int(restored.step) == int(restored.opt.step) == 5
    for a, b in zip(_leaves(restored), _leaves(carried_state)):
        np.testing.assert_array_equal(a, b)
    _, got = _port_run(cfg, adamw.AdamWConfig(**OPT), None, _data(cfg), 2,
                       5, restored)
    rstep = jax.jit(ref_steps.make_train_step(
        ref_build(rcfg), ref_adamw.AdamWConfig(**OPT)))
    rs = ref_state
    for i, (loss, _) in enumerate(got):
        rs, st = rstep(rs, jax.tree.map(jnp.asarray, pipeline.batch_at(
            _data(cfg), 5 + i)))
        assert loss == pytest.approx(float(st["loss"]), rel=5e-3)


# ---------------------------------------------------------------------------
# entry points

def test_serve_llm_small_on_cpu(capsys):
    for arch in ("stablelm-1.6b", "qwen3-moe-235b-a22b"):
        rec = serve_llm.main(["--device", "cpu", "--arch", arch, "--batch",
                              "2", "--prompt-len", "16", "--gen", "6",
                              "--check", "4"])
        assert rec["check"]["positions"] == 5
        assert len(rec["sample"]) == 6 and rec["decode_ms_per_step"] > 0
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "decoded 5 steps x batch 2" in out
    assert serve_llm.parser().parse_args([]).reduced is True
    assert serve_llm.parser().parse_args(["--no-reduced"]).reduced is False


G2_ARCHS = ["llama-3.2-vision-11b", "rwkv6-1.6b", "seamless-m4t-large-v2",
            "zamba2-7b"]


@pytest.mark.parametrize("arch", G2_ARCHS)
def test_serve_llm_families_on_cpu(arch, capsys):
    """``serve_llm`` for the rwkv, hybrid, encdec and vlm families: the
    frontend stub drawn, the cache grown family by family, decode held to
    one forward over prompt + fed tokens (the scans' chunk cut to divide
    that length: 16 + 4 = 20 tokens against a chunk of 16)."""
    rec = serve_llm.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                          "--prompt-len", "16", "--gen", "6", "--check",
                          "4"])
    assert rec["family"] == ARCHS[arch].family
    assert rec["check"]["positions"] == 5
    assert rec["check"]["max_abs_diff"] < 0.1
    assert len(rec["sample"]) == 6
    assert "within atol 0.1 + rtol 0.05: True" in capsys.readouterr().out


def _tweaked(params):
    """Every leaf moved off its init's ones and zeros, so a leaf the models
    read in float32 would round if the serving copy cast it."""
    gen = torch.Generator().manual_seed(3)
    return common.tree_map(lambda p: p + 0.3 * torch.randn(
        p.shape, generator=gen), params)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serving_params_drawn_leaf_by_leaf(arch):
    """``init_serving_params`` (each leaf cast as it is drawn) is
    ``serving_params(init_params(...))`` bit for bit, and the serving copy
    gives the float32 params' prefill and decode logits bit for bit."""
    from repro_torch.models import init_params
    cfg = ARCHS[arch].reduced()
    if cfg.family == "vlm":
        # 8 groups: a tanh gate rounded to bf16 before its tanh changes
        # the product's bits for ~20% of gate values, so 16 gates show it
        cfg = dataclasses.replace(cfg, n_layers=16)
    api = build(cfg)
    a = serve_llm.init_serving_params(api, torch.Generator().manual_seed(4))
    b = serve_llm.serving_params(init_params(
        api, torch.Generator().manual_seed(4)))
    for (pa, x), (pb, y) in zip(tree_leaves_with_path(a),
                                tree_leaves_with_path(b)):
        assert pa == pb and x.dtype == y.dtype and torch.equal(x, y), pa
    params = _tweaked(init_params(api, torch.Generator().manual_seed(0)))
    served = serve_llm.serving_params(params)
    assert any(p.dtype == torch.bfloat16 for p in common.tree_leaves(served))
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    batch = {"tokens": tokens, **serve_llm.frontend_inputs(
        cfg, 2, 16, gen, "cpu")}
    with torch.no_grad():
        outs = []
        for p in (params, served):
            logits, cache = api.prefill(p, batch)
            cache = serve_llm.grow_cache(cache, 17, cfg.family)
            step, _ = api.decode(p, {"token": tokens[:, -1], "pos": 16},
                                 cache)
            outs.append((logits, step))
    for x, y in zip(*outs):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_train_launcher_frontend_on_cpu(arch, tmp_path):
    """The launcher trains encdec and vlm on ``frontend_stub``'s embeddings
    (in bf16), as the reference's; the first loss equals the loss of the
    launcher's first batch computed here."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import init_params
    rec = train.main(["--device", "cpu", "--reduced", "--arch", arch,
                      "--global-batch", "2", "--seq-len", "32", "--steps",
                      "3", "--ckpt-dir", str(tmp_path)])
    assert len(rec["loss"]) == 3 and np.isfinite(rec["loss"]).all()
    cfg = ARCHS[arch].reduced()
    api = build(cfg)
    batch = {k: torch.from_numpy(v) for k, v in pipeline.batch_at(
        pipeline.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2),
        0).items()}
    stub = pipeline.frontend_stub(cfg, ShapeConfig("train", 32, 2, "train"),
                                  0)
    key = "src_embed" if cfg.family == "encdec" else "img_embed"
    batch[key] = torch.from_numpy(stub).bfloat16()
    with torch.no_grad():
        want = float(api.loss(init_params(
            api, torch.Generator().manual_seed(0)), batch))
    assert rec["loss"][0] == pytest.approx(want, rel=1e-6)


def test_train_launcher_small_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--reduced", "--global-batch", "4",
            "--seq-len", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "4"]
    rec = train.main(argv + ["--steps", "6"])
    assert len(rec["loss"]) == 6 and np.isfinite(rec["loss"]).all()
    assert [s for s, _ in rec["saves"]] == [4, 6]
    assert rec["ckpt_bytes"] > 0
    again = train.main(argv + ["--steps", "8"])
    assert again["start_step"] == 6 and len(again["loss"]) == 2
    assert "resumed from step 6" in capsys.readouterr().out
    for mesh, need in (("single", 256), ("multi", 512)):
        with pytest.raises(ValueError, match=f"need {need} devices"):
            train.main(argv + ["--steps", "1", "--mesh", mesh])


def test_train_lm_example_small_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_train_lm.py"),
         "--device", "cpu", "--layers", "2", "--d-model", "64", "--heads",
         "4", "--d-ff", "128", "--vocab", "512", "--seq-len", "32",
         "--steps", "25", "--ckpt-every", "10", "--ckpt-dir",
         str(tmp_path)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "model: 0.1M params on cpu" in out.stdout
    assert "step   24" in out.stdout and "done" in out.stdout
    assert checkpoint.latest_step(str(tmp_path)) == 20


def test_entry_points_raise_without_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import torch_train_lm
    finally:
        sys.path.remove(str(REPO / "examples"))
    for call in (lambda: serve_llm.main([]),
                 lambda: train.main(["--ckpt-dir", str(tmp_path)]),
                 lambda: torch_train_lm.main(["--ckpt-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
