"""The port's LLM models (``repro_torch.configs`` / ``repro_torch.models``)
against the reference's on the CPU.

The same inputs, drawn with numpy from a seed, and the same weights (the
reference's init carried across with ``convert.params_from_reference``)
go through both packages:

* configs, shapes and the runnable-cell rule equal field for field;
  parameter counts and spec trees of all ten architectures equal at full
  size with nothing allocated; the init's leaf-name rules;
* the shared ops (``dense`` without a bias is bit-identical: both round
  a float32 accumulation once), flash attention forward and grads
  (``tests/test_models_numerics.py``'s cases, port against the
  reference's ``chunked_attention``), ``decode_attention`` and
  ``attention`` with ``qkv_bias`` and ``memory=``;
* whole models: the loss (rtol 1e-3), prefill logits and cache, and
  decode logits (atol 5e-2) of reduced stablelm-1.6b, qwen2.5-14b (qkv
  bias), kimi-k2 (shared expert) and qwen3-moe, under both MoE
  dispatches, ``ce_chunked`` and ``remat`` on and off;
* the port's own decode-matches-prefill and arch smoke (every
  architecture), mirroring ``tests/test_models_numerics.py`` and
  ``tests/test_models_smoke.py``.  The rwkv, hybrid, encdec and vlm
  families' parity tests are ``tests/test_torch_families*.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import base as ref_base
from repro.models import attention as ref_attention
from repro.models import build as ref_build
from repro.models import common as ref_common
from repro.models import init_params as ref_init
from repro_torch.configs import ARCHS, base
from repro_torch.convert import params_from_reference
from repro_torch.models import (attention, build, common, dense,
                                init_params, input_specs, moe)
from repro_torch.models.common import ParamSpec, tree_leaves_with_path

PORTED = sorted(ARCHS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six
    workers on the CPU, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ref_params(cfg, seed=0):
    rp = ref_init(ref_build(cfg), jax.random.PRNGKey(seed))
    return rp, params_from_reference(jax.device_get(rp), "cpu")


# ---------------------------------------------------------------------------
# configs and counts

@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_config_equals_reference(arch):
    """Every field of the config and its reduced / optimized variants,
    ``hd``, ``vocab_padded`` and the runnable cells equal the reference's."""
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    ref, port = REF_ARCHS[arch], ARCHS[arch]
    for r, p in ((ref, port), (ref.reduced(), port.reduced()),
                 (ref.optimized(), port.optimized()),
                 (ref.reduced().optimized(), port.reduced().optimized())):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert (p.hd, p.vocab_padded) == (r.hd, r.vocab_padded)
        assert [base.cell_is_runnable(p, s) for s in base.SHAPES] == [
            ref_base.cell_is_runnable(r, s) for s in ref_base.SHAPES]


def test_shapes_equal_reference():
    assert [dataclasses.asdict(s) for s in base.SHAPES] == [
        dataclasses.asdict(s) for s in ref_base.SHAPES]
    assert sorted(base.SHAPES_BY_NAME) == sorted(ref_base.SHAPES_BY_NAME)
    assert base.LONG_CONTEXT_FAMILIES == ref_base.LONG_CONTEXT_FAMILIES
    assert [f.name for f in dataclasses.fields(base.ModelConfig)] == [
        f.name for f in dataclasses.fields(ref_base.ModelConfig)]


@pytest.mark.parametrize("arch", PORTED)
def test_param_counts_full_configs(arch):
    """Full-size counts and spec trees (paths, shapes) equal the
    reference's; the specs are records, so a 1 T-parameter config
    allocates nothing."""
    api, ref = build(ARCHS[arch]), ref_build(REF_ARCHS[arch])
    assert api.num_params == ref.num_params
    assert api.num_active_params == ref.num_active_params
    ours = tree_leaves_with_path(api.param_specs)
    theirs = jax.tree_util.tree_flatten_with_path(ref.param_specs)[0]
    assert [p for p, _ in ours] == [
        "/".join(str(k.key) for k in path) for path, _ in theirs]
    assert [s.shape for _, s in ours] == [s.shape for _, s in theirs]
    assert all(isinstance(s, ParamSpec) for _, s in ours)
    if ARCHS[arch].family == "moe":
        assert api.num_active_params < api.num_params


def test_unported_families_raise():
    """Every family of the configs is ported; an unknown one raises
    ``ValueError``, as the reference's ``build`` does."""
    from repro_torch.models.model_zoo import FAMILIES, family_module
    assert sorted({c.family for c in ARCHS.values()}) == sorted(FAMILIES)
    cfg = dataclasses.replace(ARCHS["stablelm-1.6b"], family="retnet")
    for call in (build, family_module):
        with pytest.raises(ValueError, match="unknown family retnet"):
            call(cfg)
    with pytest.raises(ValueError, match="unknown family retnet"):
        ref_build(dataclasses.replace(REF_ARCHS["stablelm-1.6b"],
                                      family="retnet"))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2.5-14b",
                                  "kimi-k2-1t-a32b"])
def test_init_rules_match_reference(arch):
    """The same leaves are ones, zeros or a +-3 sigma truncated normal with
    the reference's sigma (the draws' bits are each package's own)."""
    cfg = ARCHS[arch].reduced()
    rp, _ = _ref_params(REF_ARCHS[arch].reduced())
    pp = init_params(build(cfg), torch.Generator().manual_seed(0))
    theirs = dict((("/".join(str(k.key) for k in path)), np.asarray(x))
                  for path, x in jax.tree_util.tree_flatten_with_path(rp)[0])
    ours = dict(tree_leaves_with_path(pp))
    assert sorted(ours) == sorted(theirs)
    for path, r in theirs.items():
        p = ours[path].numpy()
        assert p.dtype == r.dtype and p.shape == r.shape
        if np.all(r == 1) or np.all(r == 0):
            np.testing.assert_array_equal(p, r, err_msg=path)
            continue
        fan_in = r.shape[-2] if r.ndim >= 2 else r.shape[-1]
        sigma = min(0.02, fan_in ** -0.5)
        assert np.abs(p).max() <= 3 * sigma * (1 + 1e-6), path
        assert np.abs(r).max() <= 3 * sigma * (1 + 1e-6), path
        assert p.std() == pytest.approx(r.std(), rel=0.1), path
        assert abs(p.mean()) < 0.1 * sigma, path


# ---------------------------------------------------------------------------
# shared ops

def test_common_ops_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) * 0.05).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    tx, tw, tb = _t(x), _t(w), _t(b)
    # no bias: one rounding of a float32 accumulation, the same bits
    np.testing.assert_array_equal(_np(common.dense(tx, tw)),
                                  _np(ref_common.dense(jx, jw)))
    np.testing.assert_array_equal(
        _np(common.dense(tx, tw, tb, bf16_wire=True)),
        _np(ref_common.dense(jx, jw, jb, bf16_wire=True)))
    np.testing.assert_allclose(_np(common.dense(tx, tw, tb)),
                               _np(ref_common.dense(jx, jw, jb)),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_array_equal(
        _np(common.rms_norm(tx.bfloat16(), _t(scale))),
        _np(ref_common.rms_norm(jx.astype(jnp.bfloat16), jnp.asarray(scale))))
    pos = np.arange(16)
    ang, rang = (common.rope_angles(_t(pos), 16, 10_000.0),
                 ref_common.rope_angles(jnp.asarray(pos), 16, 10_000.0))
    np.testing.assert_allclose(_np(ang), _np(rang), rtol=1e-6)
    q = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(common.apply_rope(_t(q).bfloat16(), ang)),
        _np(ref_common.apply_rope(jnp.asarray(q, jnp.bfloat16), rang)),
        atol=1e-2)
    w1, w3 = ((rng.standard_normal((64, 128)) * 0.05).astype(np.float32)
              for _ in range(2))
    w2 = (rng.standard_normal((128, 64)) * 0.05).astype(np.float32)
    np.testing.assert_allclose(
        _np(common.swiglu(tx, _t(w1), _t(w3), _t(w2))),
        _np(ref_common.swiglu(jx, jnp.asarray(w1), jnp.asarray(w3),
                              jnp.asarray(w2))), atol=2e-3, rtol=1e-2)
    logits = rng.standard_normal((2, 16, 96)).astype(np.float32)
    labels = rng.integers(0, 96, (2, 16)).astype(np.int32)
    assert float(common.softmax_cross_entropy(_t(logits), _t(labels))) == \
        pytest.approx(float(ref_common.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels))), rel=1e-6)


# ---------------------------------------------------------------------------
# attention

@pytest.mark.parametrize("b,sq,skv,h,kv,hd,causal,cq,ck", [
    (2, 64, 64, 4, 2, 16, True, 16, 16),
    (1, 32, 32, 8, 8, 8, True, 32, 8),
    (2, 64, 128, 4, 1, 16, False, 16, 32),
    (1, 48, 80, 4, 4, 8, False, 16, 16),   # non-pow2 kv len via gcd
])
def test_flash_forward_and_grads(b, sq, skv, h, kv, hd, causal, cq, ck):
    """The autograd.Function against the reference's custom VJP."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))
    co = rng.standard_normal((b, sq, h, hd)).astype(np.float32)

    def ref_f(q, k, v):
        return ref_attention.chunked_attention(q, k, v, causal=causal,
                                               chunk_q=cq, chunk_kv=ck)

    want = ref_f(*(jnp.asarray(a) for a in (q, k, v)))
    ref_g = jax.grad(lambda *a: jnp.sum(ref_f(*a).astype(jnp.float32)
                                        * jnp.asarray(co)),
                     argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = attention.chunked_attention(tq, tk, tv, causal=causal, chunk_q=cq,
                                      chunk_kv=ck)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(want), atol=1e-2, rtol=1e-2)
    grads = torch.autograd.grad((out.float() * _t(co)).sum(), (tq, tk, tv))
    for got, exp in zip(grads, ref_g):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(exp), atol=5e-2, rtol=2e-2)


def test_flash_skips_only_masked_blocks():
    """Skipping the all-masked causal blocks is exact: chunks that make
    no block all-masked (one chunk) and chunks that do give the same bits
    for the rows whose blocks line up."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.standard_normal((1, 32, 2, 8)).astype(np.float32))
               for _ in range(3))
    kinds = [attention._block_kind(True, iq * 8, iq * 8 + 7, jk * 8,
                                   jk * 8 + 7)
             for iq in range(4) for jk in range(4)]
    assert kinds.count("skip") == 6 and kinds.count("mask") == 4
    a = attention.chunked_attention(q, k, v, causal=True, chunk_q=8,
                                    chunk_kv=8)
    b = attention.chunked_attention(q, k, v, causal=True, chunk_q=8,
                                    chunk_kv=32)
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-2)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
              for _ in range(2))
    for pos in (0, 9, 23):
        got = attention.decode_attention(
            _t(q), attention.KVCache(_t(ck), _t(cv)), pos)
        want = ref_attention.decode_attention(
            jnp.asarray(q), ref_attention.KVCache(jnp.asarray(ck),
                                                  jnp.asarray(cv)),
            jnp.int32(pos))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("mode", ["self_bias", "cross", "cross_decode",
                                  "self_decode", "return_cache"])
def test_attention_modes_match_reference(mode):
    """``attention`` with ``qkv_bias``: self-attention, cross-attention
    (``memory=``), cross decode, cached self decode, ``return_cache``."""
    rng = np.random.default_rng(2)
    d, h, kv, hd = 64, 4, 2, 16
    specs = attention.attn_param_specs(d, h, kv, hd, qkv_bias=True)
    p = {k: (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
         for k, s in specs.items()}
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    mem = rng.standard_normal((2, 12, d)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 16, kv, hd)).astype(np.float32)
              for _ in range(2))
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=hd, rope_theta=10_000.0,
              causal=mode != "cross", chunk_q=4, chunk_kv=4)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    tp = {k: _t(a) for k, a in p.items()}
    jx, tx = jnp.asarray(x), _t(x)
    if mode in ("cross_decode", "self_decode"):
        jx, tx = jx[:, :1], tx[:, :1]
    extra_j, extra_t = {}, {}
    if mode in ("cross", "cross_decode"):
        extra_j["memory"], extra_t["memory"] = (
            jnp.asarray(mem).astype(jnp.bfloat16), _t(mem).bfloat16())
    if mode in ("cross_decode", "self_decode"):
        extra_j["cache"] = ref_attention.KVCache(
            jnp.asarray(ck, jnp.bfloat16), jnp.asarray(cv, jnp.bfloat16))
        extra_t["cache"] = attention.KVCache(_t(ck).bfloat16(),
                                             _t(cv).bfloat16())
    if mode == "self_decode":
        extra_j["pos"], extra_t["pos"] = jnp.int32(5), 5
    if mode == "return_cache":
        extra_j["return_cache"] = extra_t["return_cache"] = True
    want, wc = ref_attention.attention(jx.astype(jnp.bfloat16), jp, **kw,
                                       **extra_j)
    got, gc = attention.attention(tx.bfloat16(), tp, **kw, **extra_t)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)
    assert (gc is None) == (wc is None)
    if gc is not None:
        for a, b in zip(gc, wc):
            np.testing.assert_allclose(_np(a), _np(b), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# whole models

MODEL_CASES = [
    ("stablelm-1.6b", {}),
    ("stablelm-1.6b", {"ce_chunked": 16, "remat": False}),
    ("qwen2.5-14b", {}),
    ("kimi-k2-1t-a32b", {"moe_dispatch": "cumsum"}),
    ("kimi-k2-1t-a32b", {"moe_dispatch": "sort", "remat": False}),
    ("qwen3-moe-235b-a22b", {"moe_dispatch": "cumsum"}),
    ("qwen3-moe-235b-a22b", {"moe_dispatch": "sort", "ce_chunked": 8}),
]


@pytest.mark.parametrize("arch,knobs", MODEL_CASES)
def test_model_matches_reference(arch, knobs):
    """Loss, prefill logits and cache, and four decode steps against the
    reference on the same weights and tokens."""
    rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(), **knobs)
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **knobs)
    ref, api = ref_build(rcfg), build(cfg)
    rp, pp = _ref_params(rcfg)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    want = float(ref.loss(rp, {"tokens": jnp.asarray(tok),
                               "labels": jnp.asarray(lab)}))
    got = float(api.loss(pp, {"tokens": _t(tok), "labels": _t(lab)}))
    assert got == pytest.approx(want, rel=1e-3)

    rl, rc = ref.prefill(rp, {"tokens": jnp.asarray(tok[:, :24])})
    pl, pc = api.prefill(pp, {"tokens": _t(tok[:, :24])})
    assert pl.dtype == torch.bfloat16 and pl.shape == rl.shape
    np.testing.assert_allclose(_np(pl), _np(rl), atol=5e-2)
    for a, b in zip(pc, rc):
        assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-2)

    rc = jax.tree.map(lambda c: jnp.pad(
        c, ((0, 0), (0, 0), (0, 8), (0, 0), (0, 0))), rc)
    pc = attention.KVCache(*(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 8))
                             for c in pc))
    for t in range(24, 28):
        rl, rc = ref.decode(rp, {"token": jnp.asarray(tok[:, t]),
                                 "pos": jnp.int32(t)}, rc)
        pl, pc = api.decode(pp, {"token": _t(tok[:, t]), "pos": t}, pc)
        np.testing.assert_allclose(_np(pl), _np(rl), atol=5e-2)
    np.testing.assert_allclose(_np(pc.k), _np(rc.k), atol=5e-2)


def test_moe_dispatches_give_the_same_positions():
    """``"sort"`` and ``"cumsum"`` rank a choice among the earlier
    choices of its expert in token order, exactly."""
    cfg = ARCHS["qwen3-moe-235b-a22b"].reduced()
    choice = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.n_experts, (64, cfg.top_k)))
    a = moe._buffer_positions(choice, dataclasses.replace(
        cfg, moe_dispatch="sort"))
    b = moe._buffer_positions(choice, dataclasses.replace(
        cfg, moe_dispatch="cumsum"))
    assert torch.equal(a, b)
    assert int(a.max()) < choice.numel()


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen3-moe-235b-a22b"])
def test_decode_matches_prefill(arch):
    """Token-by-token decode equals the teacher-forced forward (the
    reference's ``test_decode_matches_prefill_dense``, for MoE too)."""
    cfg = ARCHS[arch].reduced()
    api = build(cfg)
    mod = dense if cfg.family == "dense" else moe
    params = init_params(api, torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 24),
                        generator=torch.Generator().manual_seed(1))
    full = mod.forward(params, tok, cfg)
    full = full[0] if isinstance(full, tuple) else full
    logits, cache = mod.prefill(params, tok[:, :16], cfg)
    cache = attention.KVCache(*(torch.nn.functional.pad(
        c, (0, 0, 0, 0, 0, 8)) for c in cache))
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, 15]),
                               atol=0.1, rtol=0.05)
    for t in range(16, 20):
        logits, cache = mod.decode_step(params, tok[:, t], t, cache, cfg)
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, t]),
                                   atol=0.1, rtol=0.05)


@pytest.mark.parametrize("arch", PORTED)
def test_arch_smoke(arch):
    """The reference's ``test_arch_smoke`` for the port: finite loss and
    grads, prefill logits of the padded vocab (the vlm's is unpadded),
    one decode step against a fresh cache or state keeps its shapes."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.steps import value_and_grad
    cfg = ARCHS[arch].reduced()
    api = build(cfg)
    params = init_params(api, torch.Generator().manual_seed(0))
    specs, _ = input_specs(cfg, ShapeConfig("smoke_train", 32, 2, "train"))
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, s.shape, generator=gen,
                              dtype=torch.int32) if s.dtype == torch.int32
             else torch.randn(s.shape, generator=gen).to(s.dtype)
             for k, s in specs.items()}
    loss, grads = value_and_grad(api.loss, params, batch)
    assert np.isfinite(float(loss))
    gnorm = sum(float((g.float() ** 2).sum())
                for _, g in tree_leaves_with_path(grads))
    assert np.isfinite(gnorm) and gnorm > 0
    vocab = cfg.vocab if cfg.family == "vlm" else cfg.vocab_padded
    with torch.no_grad():
        logits, _ = api.prefill(params, {k: v for k, v in batch.items()
                                         if k != "labels"})
    assert logits.shape == (2, 1, vocab)
    assert torch.isfinite(logits.float()).all()
    _, cspecs = input_specs(cfg, ShapeConfig("smoke_decode", 32, 2,
                                             "decode"))
    cache = common.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                            cspecs)
    with torch.no_grad():
        dl, new = api.decode(params, {"token": batch["tokens"][:, 0],
                                      "pos": 3}, cache)
    assert dl.shape == (2, 1, vocab)
    assert torch.isfinite(dl.float()).all()
    assert type(new) is type(cache)
    assert [c.shape for c in common.tree_leaves(new)] == [
        c.shape for c in common.tree_leaves(cache)]


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "qwen3-moe-235b-a22b"])
def test_moe_router_balance_loss_positive(arch):
    cfg = ARCHS[arch].reduced()
    params = init_params(build(cfg), torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 32),
                        generator=torch.Generator().manual_seed(2))
    _, aux = moe.forward(params, tok, cfg)
    assert float(aux) > 0.5   # ~1.0 for uniform routing
