"""Shared pieces of the tests that hold the port's rwkv, hybrid, encdec and
vlm families to the reference's (``tests/test_torch_families*.py``).

The same inputs, drawn with numpy from a seed, and the same weights (the
reference's init of a reduced config, carried across with
``convert.params_from_reference``) go through both packages.
``strengthened`` sets every gate, norm scale, token-shift mix and decay
term to order one and scales the cross-attention projections up, so no
branch hides under the init's 0.02 gates and weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import build as ref_build
from repro.models import init_params as ref_init
from repro.optim import adamw as ref_adamw
from repro.train import steps as ref_steps
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_reference
from repro_torch.data import pipeline
from repro_torch.launch.serve_llm import grow_cache
from repro_torch.models import build
from repro_torch.models.common import tree_leaves, tree_leaves_with_path
from repro_torch.models.model_zoo import family_module
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.train.steps import value_and_grad

FAMILY_ARCH = {"rwkv": "rwkv6-1.6b", "hybrid": "zamba2-7b",
               "encdec": "seamless-m4t-large-v2",
               "vlm": "llama-3.2-vision-11b"}
G2 = sorted(FAMILY_ARCH.values())
SEQ, PROMPT, N_DEC, SRC = 32, 16, 4, 24     # SRC != batch 2: the trap
WEIGHTS_REMAT = [("init", True), ("strong", True), ("strong", False)]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


_HOSTS = {}


def ref_host(arch: str):
    """The reference's init of ``arch``'s reduced config, as host arrays
    (drawn once a process)."""
    if arch not in _HOSTS:
        rcfg = REF_ARCHS[arch].reduced()
        _HOSTS[arch] = jax.device_get(
            jax.jit(lambda k: ref_init(ref_build(rcfg), k))(
                jax.random.PRNGKey(0)))
    return _HOSTS[arch]


def leaf_name(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def strengthened(host, seed: int = 7):
    """``host`` with every gate, norm scale, token-shift mix and decay
    term drawn at order one and the cross-attention projections x10."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = leaf_name(path)
        a = np.asarray(a)
        if "gate_" in name:
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        if "/mix_" in name:
            return rng.uniform(0.0, 1.0, a.shape).astype(a.dtype)
        if any(s in name for s in ("norm", "/ln1", "/ln2", "gn_scale")):
            return (1 + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        if any(s in name for s in ("decay0", "A_log", "skip_D")):
            return rng.standard_normal(a.shape).astype(a.dtype)
        if "dt_bias" in name:
            return (rng.standard_normal(a.shape) - 1).astype(a.dtype)
        if "bonus_u" in name:
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        if "cross/w" in name or "cross_layers/attn/" in name:
            return a * 10
        return a

    return jax.tree_util.tree_map_with_path(leaf, host)


def weights(arch: str, kind: str):
    """(reference params, port params) of ``kind`` "init" or "strong"."""
    host = ref_host(arch)
    if kind == "strong":
        host = strengthened(host)
    return jax.tree.map(jnp.asarray, host), params_from_reference(host,
                                                                  "cpu")


def inputs(cfg, batch: int = 2, seed: int = 5) -> dict:
    """tokens / labels (batch, SEQ) and the family's frontend stub."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab, (batch, SEQ)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        out["src_embed"] = rng.standard_normal(
            (batch, SRC, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["img_embed"] = rng.standard_normal(
            (batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


def ref_batch(x: dict) -> dict:
    """Reference inputs: the stub's embeddings in bf16."""
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32
                           else None) for k, v in x.items()}


def port_batch(x: dict) -> dict:
    return {k: t(v).bfloat16() if v.dtype == np.float32 else t(v)
            for k, v in x.items()}


def prompt(batch: dict) -> dict:
    return {k: (v[:, :PROMPT] if k == "tokens" else v)
            for k, v in batch.items() if k != "labels"}


def ref_grow(family, cache, max_len):
    """The reference serving loop's family-aware cache growth
    (``src/repro/launch/serve_llm.py``)."""
    def pad(axis):
        def fn(c):
            widths = [(0, 0)] * c.ndim
            widths[axis] = (0, max_len - c.shape[axis])
            return jnp.pad(c, widths)
        return fn

    if family in ("dense", "moe"):
        return jax.tree.map(pad(2), cache)
    if family == "encdec":
        return cache._replace(self_kv=jax.tree.map(pad(2), cache.self_kv))
    if family == "vlm":
        return cache._replace(self_kv=jax.tree.map(pad(3), cache.self_kv))
    if family == "hybrid":
        return cache._replace(attn=jax.tree.map(pad(2), cache.attn))
    return cache


def configs(arch, remat=True):
    return (dataclasses.replace(REF_ARCHS[arch].reduced(), remat=remat),
            dataclasses.replace(ARCHS[arch].reduced(), remat=remat))


def forward(cfg, params, batch: dict):
    """The family's teacher-forced forward -> (B, S, V) logits."""
    mod = family_module(cfg)
    if cfg.family == "encdec":
        return mod.forward(params, batch["src_embed"], batch["tokens"], cfg)
    if cfg.family == "vlm":
        return mod.forward(params, batch["tokens"], batch["img_embed"], cfg)
    return mod.forward(params, batch["tokens"], cfg)


_REF_FNS = {}


def ref_fns(rcfg):
    """The reference's jitted (value_and_grad of the loss, prefill, decode)
    for ``rcfg``, compiled once a process."""
    if rcfg not in _REF_FNS:
        ref = ref_build(rcfg)
        _REF_FNS[rcfg] = (jax.jit(jax.value_and_grad(ref.loss)),
                          jax.jit(ref.prefill), jax.jit(ref.decode))
    return _REF_FNS[rcfg]


def check_matches_reference(arch: str, kind: str, remat: bool) -> None:
    """The loss (rel 1e-3) and its gradients, the prefill logits and cache
    or state, four decode steps and the final cache or state (atol 5e-2)
    against the reference on the same weights and inputs."""
    rcfg, cfg = configs(arch, remat)
    ref_vg, ref_prefill, ref_decode = ref_fns(rcfg)
    api = build(cfg)
    rp, pp = weights(arch, kind)
    x = inputs(cfg)
    rb, pb = ref_batch(x), port_batch(x)

    want, want_g = ref_vg(rp, rb)
    got, got_g = value_and_grad(api.loss, pp, pb)
    assert float(got) == pytest.approx(float(want), rel=1e-3)
    # bf16 products: each leaf's gradient within a tenth of its own largest
    # magnitude plus 1e-3 of the whole gradient's, the norms within 1e-2
    want_g = jax.tree.leaves(want_g)
    top = max(float(np.abs(to_np(w)).max()) for w in want_g)
    for (path, g), w in zip(tree_leaves_with_path(got_g), want_g):
        err = np.abs(to_np(g) - to_np(w)).max()
        assert err <= 0.1 * np.abs(to_np(w)).max() + 1e-3 * top, path
    norms = [np.sqrt(sum(float((to_np(g) ** 2).sum()) for g in gs))
             for gs in (tree_leaves(got_g), want_g)]
    assert norms[0] == pytest.approx(norms[1], rel=1e-2)

    rl, rc = ref_prefill(rp, prompt(rb))
    pl, pc = api.prefill(pp, prompt(pb))
    assert pl.dtype == torch.bfloat16 and tuple(pl.shape) == rl.shape
    np.testing.assert_allclose(to_np(pl), to_np(rl), atol=5e-2)
    for a, b in zip(tree_leaves(pc), jax.tree.leaves(rc)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(to_np(a), to_np(b), atol=5e-2)

    max_len = PROMPT + N_DEC
    rc = ref_grow(cfg.family, rc, max_len)
    pc = grow_cache(pc, max_len, cfg.family)
    for i in range(PROMPT, PROMPT + N_DEC):
        rl, rc = ref_decode(rp, {"token": jnp.asarray(x["tokens"][:, i]),
                                 "pos": jnp.int32(i)}, rc)
        pl, pc = api.decode(pp, {"token": t(x["tokens"][:, i]), "pos": i},
                            pc)
        np.testing.assert_allclose(to_np(pl), to_np(rl), atol=5e-2)
    for a, b in zip(tree_leaves(pc), jax.tree.leaves(rc)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(to_np(a), to_np(b), atol=5e-2)


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)


def check_train_steps(arch: str, n: int = 3) -> None:
    """``n`` train steps from the reference's init on ``pipeline``'s
    batches (and the frontend stub for encdec / vlm): the losses within
    rtol 5e-3 and the grad norms within rtol 2e-2 of the reference's
    jitted ``train_step``."""
    rcfg, cfg = configs(arch)
    host = ref_host(arch)
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=2,
                               seed=2)
    shape = ShapeConfig("train", SEQ, 2, "train")
    rstep = jax.jit(ref_steps.make_train_step(
        ref_build(rcfg), ref_adamw.AdamWConfig(**OPT)))
    rs = ref_steps.init_train_state(jax.tree.map(jnp.asarray, host))
    pstep = steps.make_train_step(build(cfg), adamw.AdamWConfig(**OPT))
    ps = steps.init_train_state(params_from_reference(host, "cpu"))
    for i in range(n):
        b = pipeline.batch_at(data, i)
        extra = pipeline.frontend_stub(cfg, shape, i)
        if extra is not None:
            b["src_embed" if cfg.family == "encdec" else "img_embed"] = extra
        rs, want = rstep(rs, ref_batch(b))
        ps, got = pstep(ps, port_batch(b))
        assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                                   rel=5e-3)
        assert float(got["grad_norm"]) == pytest.approx(
            float(want["grad_norm"]), rel=2e-2)
    assert int(ps.step) == n
