"""The port's rwkv, hybrid, encdec and vlm families
(``repro_torch.models.{rwkv,ssm,encdec,vlm}``) against the reference's on
the CPU, part 1 (``tests/torch_g2.py`` holds the shared pieces; the
whole-model parity and train steps are in
``test_torch_families_{recurrent,cross}.py``):

* the chunk scans ``wkv_chunked`` / ``wkv_ref`` / ``ssd_chunked`` /
  ``ssd_ref`` on ``tests/test_models_numerics.py``'s grids: float32
  states within rtol 1e-4, bf16 outputs within atol 2e-2, the chunked
  scans' gradients against ``jax.grad`` of the reference's within 1e-3
  of each gradient's largest magnitude; ``_causal_conv`` bit for bit;
  ``softplus`` within 3 ulp of ``jax.nn.softplus``;
* a reference cache or state carried across by
  ``convert.cache_from_reference`` decodes as the reference's; the cache
  specs and their growth in ``serve_llm``;
* decode-matches-prefill for each family in the port alone (rwkv's
  ``pos=None`` too); on the strengthened weights each branch (token
  shift, decay, shared attention, cross-attention) moves the logits
  beyond the tolerance; the cross-decode trap: attending to the first B
  positions of the stacked cross cache, not all S_src / n_img of a
  layer's slice, misses the reference by more than the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build as ref_build
from repro.models import rwkv as ref_rwkv
from repro.models import ssm as ref_ssm
from repro_torch.configs import ARCHS
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.launch.serve_llm import grow_cache
from repro_torch.models import build, init_params, rwkv, ssm
from repro_torch.models.attention import KVCache
from repro_torch.models.common import tree_leaves
from torch_g2 import (G2, N_DEC, PROMPT, configs, forward, inputs,
                      leaf_name, port_batch, prompt, ref_batch, ref_grow,
                      ref_fns, ref_host, strengthened,
                      weights)
from torch_g2 import t as _t
from torch_g2 import to_np as _np
@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six
    workers on the CPU, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_to_scale(got, want, rtol, what=""):
    """Every element within ``rtol`` of ``want``'s largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# chunk scans

WKV_GRID = [(2, 32, 2, 8, 8), (1, 64, 4, 16, 16), (2, 48, 1, 8, 16),
            (1, 16, 2, 4, 16)]
SSD_GRID = [(2, 32, 3, 8, 4, 8), (1, 64, 2, 16, 8, 16), (2, 24, 1, 8, 4, 12)]


def _wkv_inputs(b, s, h, hd):
    rng = np.random.default_rng(1)
    r, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    lw = (-np.exp(rng.standard_normal((b, s, h, hd)) * 0.5 - 1)
          ).astype(np.float32)
    u = (rng.standard_normal((h, hd)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((b, h, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, lw, u, s0


def _ssd_inputs(b, s, h, hd, n):
    rng = np.random.default_rng(2)
    xh = (rng.standard_normal((b, s, h, hd)) * 0.5).astype(np.float32)
    Bc, Cc = ((rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
              for _ in range(2))
    dt = (np.abs(rng.standard_normal((b, s, h))) * 0.5 + 0.01
          ).astype(np.float32)
    a_log = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, hd)) * 0.1).astype(np.float32)
    return xh, Bc, Cc, dt, a_log, s0


def _scan_against_reference(port_fn, ref_fn, args, chunk):
    """Outputs and states of the port's chunked and step-by-step scans
    against the reference's; the chunked scans' gradients against
    ``jax.grad`` of the reference's."""
    extra = () if chunk is None else (chunk,)
    want_o, want_s = ref_fn(*map(jnp.asarray, args), *extra)
    got_o, got_s = port_fn(*map(_t, args), *extra)
    assert got_o.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=2e-2)
    np.testing.assert_allclose(_np(got_s), _np(want_s), rtol=1e-4,
                               atol=1e-6)
    if chunk is None:
        return
    rng = np.random.default_rng(9)
    co = rng.standard_normal(want_o.shape).astype(np.float32)
    cs = rng.standard_normal(want_s.shape).astype(np.float32)

    def ref_loss(*a):
        o, st = ref_fn(*a, chunk)
        return jnp.sum(o.astype(jnp.float32) * co) + jnp.sum(st * cs)

    want = jax.grad(ref_loss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ts = [_t(a).requires_grad_(True) for a in args]
    o, st = port_fn(*ts, chunk)
    got = torch.autograd.grad((o.float() * _t(co)).sum()
                              + (st * _t(cs)).sum(), ts)
    for i, (g, w) in enumerate(zip(got, want)):
        _close_to_scale(g, w, 1e-3, f"grad {i}")


@pytest.mark.parametrize("b,s,h,hd,chunk", WKV_GRID)
def test_wkv_scans_match_reference(b, s, h, hd, chunk):
    args = _wkv_inputs(b, s, h, hd)
    _scan_against_reference(rwkv.wkv_chunked, ref_rwkv.wkv_chunked, args,
                            chunk)
    _scan_against_reference(rwkv.wkv_ref, ref_rwkv.wkv_ref, args, None)
    # and the port's chunked scan against its own recurrence (the
    # reference test's tolerance)
    out_c, s_c = rwkv.wkv_chunked(*map(_t, args), chunk)
    out_r, s_r = rwkv.wkv_ref(*map(_t, args))
    np.testing.assert_allclose(_np(out_c), _np(out_r), atol=0.02, rtol=0.02)
    np.testing.assert_allclose(_np(s_c), _np(s_r), atol=0.02, rtol=0.02)


@pytest.mark.parametrize("b,s,h,hd,n,chunk", SSD_GRID)
def test_ssd_scans_match_reference(b, s, h, hd, n, chunk):
    args = _ssd_inputs(b, s, h, hd, n)
    _scan_against_reference(ssm.ssd_chunked, ref_ssm.ssd_chunked, args,
                            chunk)
    _scan_against_reference(ssm.ssd_ref, ref_ssm.ssd_ref, args, None)
    out_c, s_c = ssm.ssd_chunked(*map(_t, args), chunk)
    out_r, s_r = ssm.ssd_ref(*map(_t, args))
    np.testing.assert_allclose(_np(out_c), _np(out_r), atol=0.02, rtol=0.02)
    np.testing.assert_allclose(_np(s_c), _np(s_r), atol=0.02, rtol=0.02)


def test_scans_refuse_a_length_off_the_chunk():
    """The reference asserts ``s % chunk == 0``; the port raises."""
    args = [_t(a) for a in _wkv_inputs(1, 24, 1, 4)]
    with pytest.raises(ValueError, match="multiple of the chunk 16"):
        rwkv.wkv_chunked(*args, 16)
    args = [_t(a) for a in _ssd_inputs(1, 24, 1, 4, 4)]
    with pytest.raises(ValueError, match="multiple of the chunk 16"):
        ssm.ssd_chunked(*args, 16)


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_bitwise(carry):
    """The W taps summed in float32 in the reference's order: the same
    bits, output and carry."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32)).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    c = rng.standard_normal((2, 3, 32)).astype(np.float32) if carry else None
    want, want_c = ref_ssm._causal_conv(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(bias),
        None if c is None else jnp.asarray(c, jnp.bfloat16))
    got, got_c = ssm._causal_conv(
        _t(x).bfloat16(), _t(w), _t(bias),
        None if c is None else _t(c).bfloat16())
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_c), _np(want_c))


def test_softplus_within_3_ulp():
    """``logaddexp(x, 0)``, ``jax.nn.softplus``'s form: XLA's ``exp`` is
    not torch's, so a few elements differ, by at most 3 ulp."""
    x = (np.random.default_rng(4).standard_normal(200_000) * 10
         ).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ssm.softplus(_t(x)).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 3
    assert (ulp > 0).mean() < 0.05


@pytest.mark.parametrize("arch", G2)
def test_cache_from_reference_decodes_like_reference(arch):
    """A reference prefill's cache or state carried across with
    ``convert.cache_from_reference`` (the port's NamedTuples, the
    hybrid's ``pos`` scalar too) decodes to the reference's logits."""
    rcfg, cfg = configs(arch)
    _, ref_prefill, ref_decode = ref_fns(rcfg)
    api = build(cfg)
    rp, pp = weights(arch, "strong")
    x = inputs(cfg)
    _, rc = ref_prefill(rp, prompt(ref_batch(x)))
    rc = ref_grow(cfg.family, rc, PROMPT + 1)
    pc = cache_from_reference(jax.device_get(rc), "cpu")
    assert type(pc).__module__.startswith("repro_torch.models")
    assert type(pc).__name__ == type(rc).__name__
    for a, b in zip(tree_leaves(pc), jax.tree.leaves(rc)):
        np.testing.assert_array_equal(_np(a), _np(b))
        assert a.dtype == getattr(torch, str(b.dtype))
    tok = x["tokens"][:, PROMPT]
    rl, _ = ref_decode(rp, {"token": jnp.asarray(tok),
                            "pos": jnp.int32(PROMPT)}, rc)
    pl, _ = api.decode(pp, {"token": _t(tok), "pos": PROMPT}, pc)
    np.testing.assert_allclose(_np(pl), _np(rl), atol=5e-2)


@pytest.mark.parametrize("arch", G2)
def test_decode_matches_prefill(arch):
    """Token-by-token decode equals the teacher-forced forward in the port
    alone (the reference's ``test_decode_matches_prefill_rwkv``, for every
    family; rwkv's decode takes ``pos=None``)."""
    cfg = ARCHS[arch].reduced()
    api = build(cfg)
    params = init_params(api, torch.Generator().manual_seed(0))
    batch = port_batch(inputs(cfg, seed=1))
    with torch.no_grad():
        full = forward(cfg, params, batch)
        logits, cache = api.prefill(params, prompt(batch))
        cache = grow_cache(cache, PROMPT + N_DEC, cfg.family)
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, PROMPT - 1]),
                                   atol=0.1, rtol=0.05)
        for t in range(PROMPT, PROMPT + N_DEC):
            pos = None if cfg.family == "rwkv" else t
            logits, cache = api.decode(
                params, {"token": batch["tokens"][:, t], "pos": pos}, cache)
            np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, t]),
                                       atol=0.1, rtol=0.05)
    if cfg.family == "hybrid":
        assert int(cache.pos) == PROMPT + N_DEC


# each branch's leaves, zeroed: the logits must move beyond 5e-2
BRANCHES = [
    ("rwkv6-1.6b", "token shift", ("/mix_",)),
    ("rwkv6-1.6b", "decay", ("decay0",)),
    ("zamba2-7b", "shared attention", ("shared_attn/attn/wo",)),
    ("seamless-m4t-large-v2", "cross-attention", ("cross/wo",)),
    ("llama-3.2-vision-11b", "cross-attention", ("gate_attn",)),
]


@pytest.mark.parametrize("arch,branch,leaves", BRANCHES)
def test_strengthened_branches_move_the_logits(arch, branch, leaves):
    """On the strengthened weights each branch moves the prefill logits by
    more than the 5e-2 the parity tests allow, so a broken branch cannot
    pass them."""
    cfg = ARCHS[arch].reduced()
    api = build(cfg)
    host = strengthened(ref_host(arch))
    cut = jax.tree_util.tree_map_with_path(
        lambda p, a: np.zeros_like(a) if any(
            s in "/" + leaf_name(p) for s in leaves) else a, host)
    batch = prompt(port_batch(inputs(cfg)))
    with torch.no_grad():
        a, _ = api.prefill(params_from_reference(host, "cpu"), batch)
        b, _ = api.prefill(params_from_reference(cut, "cpu"), batch)
    assert float((a.float() - b.float()).abs().max()) > 5e-2, branch


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llama-3.2-vision-11b"])
def test_cross_decode_reads_every_source_position(arch):
    """The cross-attention at decode reads a layer's own (B, S_src, KV, hd)
    (encdec) or group's (B, n_img, KV, hd) (vlm) slice -- every position.
    Reading ``shape[1]`` off the stacked cache instead (B = 2 positions)
    misses the reference's decode by more than 5e-2; the port is within
    it."""
    rcfg, cfg = configs(arch)
    _, ref_prefill, ref_decode = ref_fns(rcfg)
    api = build(cfg)
    rp, pp = weights(arch, "strong")
    x = inputs(cfg)
    _, rc = ref_prefill(rp, prompt(ref_batch(x)))
    rc = ref_grow(cfg.family, rc, PROMPT + 1)
    b = x["tokens"].shape[0]
    n_src = rc.cross_kv.k.shape[-3]
    assert n_src != b
    tok = x["tokens"][:, PROMPT]
    want, _ = ref_decode(rp, {"token": jnp.asarray(tok),
                              "pos": jnp.int32(PROMPT)}, rc)
    pc = cache_from_reference(jax.device_get(rc), "cpu")
    got, _ = api.decode(pp, {"token": _t(tok), "pos": PROMPT}, pc)
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-2)
    # the trap: only the first B source positions attended to
    trap = cache_from_reference(jax.device_get(rc), "cpu")
    trap = trap._replace(cross_kv=KVCache(*(c[..., :b, :, :].contiguous()
                                            for c in trap.cross_kv)))
    wrong, _ = api.decode(pp, {"token": _t(tok), "pos": PROMPT}, trap)
    assert float(np.abs(_np(wrong) - _np(want)).max()) > 5e-2


@pytest.mark.parametrize("arch", G2)
def test_cache_shapes_and_growth(arch):
    """``cache_specs`` equal the reference's; the prefill's cache grows on
    the family's position axis only (rwkv's state not at all)."""
    rcfg, cfg = configs(arch)
    api = build(cfg)
    want = ref_build(rcfg).cache_specs(2, 40)
    got = api.cache_specs(2, 40)
    assert [s.shape for s in tree_leaves(got)] == [
        s.shape for s in jax.tree.leaves(want)]
    assert [s.dtype for s in tree_leaves(got)] == [
        getattr(torch, str(s.dtype)) for s in jax.tree.leaves(want)]
    params = init_params(api, torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, cache = api.prefill(params, prompt(port_batch(inputs(cfg))))
    grown = grow_cache(cache, 40, cfg.family)
    assert type(grown) is type(cache)
    full = api.cache_specs(2, 40)
    for g, c, s in zip(tree_leaves(grown), tree_leaves(cache),
                       tree_leaves(full)):
        if cfg.family == "encdec" and tuple(g.shape) != s.shape:
            # the cross cache keeps the prompt's source length
            assert g.shape == c.shape and s.shape[2] == 4096
            continue
        assert tuple(g.shape) == s.shape
        idx = tuple(slice(0, n) for n in c.shape)
        assert torch.equal(g[idx], c)
