"""Batched LLM-inference serving demo: prefill a batch of prompts, decode.

The port of ``repro.launch.serve_llm`` (the MODELS side of the repo; the
multi-tenant partition scheduler is ``repro_torch.serve``).  It runs on
the CUDA card unless ``--device cpu`` asks for the CPU::

    PYTHONPATH=src python -m repro_torch.launch.serve_llm \\
        --arch stablelm-1.6b --no-reduced --batch 8 --prompt-len 1024 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve_llm --device cpu \\
        --batch 4 --prompt-len 32 --gen 16

``--reduced`` defaults on, as the reference's; unlike the reference's
(``store_true`` with ``default=True``), ``--no-reduced`` turns it off, so
the full-width model can be served.

The params are drawn in float32 leaf by leaf, each cast to the bf16
serving copy as soon as it is drawn (:func:`init_serving_params`), so the
peak at init is the bf16 model and one float32 leaf: the reference casts
each weight to bf16 at every use, the same bits; leaves a model reads in
float32 stay float32.  The encdec and vlm families get their frontend
stubs, ``src_embed`` (B, prompt, d) and ``img_embed`` (B, n_img, d), drawn
from the run's generator after the prompts.  The KV caches are grown to
``prompt + gen`` positions once, family by family (:func:`grow_cache`),
the prompt's entries copied in, and each decode step writes its position
in place; rwkv's recurrent state has nothing to grow.  The prefill runs twice and the second,
warm call is the one timed (the first also loads the device's kernels).  ``--check N`` holds the logits of the first
N decode steps and of the prefill to one full forward over the same
tokens and the same frontend stub (atol 0.1, rtol 0.05, the reference
test's tolerance).  The last
line of the output is a JSON record of the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import torch

from ..configs import ARCHS
from ..core.engine import resolve_device
from ..models import build
from ..models.common import (COMPUTE_DTYPE, init_from_specs,
                             tree_leaves_with_path, tree_map, tree_unflatten,
                             use_reference_numerics)
from ..models.model_zoo import family_module
from ..train import steps

# leaves some model reads in float32 (norm scales, attention biases,
# rwkv's decay and bonus, the Mamba conv / decay / skip / dt terms, the
# vlm's gates): the serving copy keeps them so
_F32_LEAVES = ("norm", "/bq", "/bk", "/bv", "/ln", "scale", "decay0",
               "bonus_u", "conv_", "A_log", "skip_D", "dt_bias", "gate_")


def _serving_leaf(path: str, p: torch.Tensor) -> torch.Tensor:
    return p if any(s in path for s in _F32_LEAVES) else p.to(COMPUTE_DTYPE)


def serving_params(params: dict) -> dict:
    """A copy of ``params`` for inference: every leaf the models only read
    through a bf16 cast is cast once, the rest stay float32."""
    return tree_unflatten(params, [_serving_leaf(path, p) for path, p in
                                   tree_leaves_with_path(params)])


def init_serving_params(api, key: torch.Generator, device=None) -> dict:
    """``serving_params(init_params(api, key, device))``, bit for bit, each
    leaf cast as soon as it is drawn."""
    return init_from_specs(api.param_specs, key, device,
                           finish=_serving_leaf)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def grow_cache(cache, max_len: int, family: str):
    """A prefill's cache with its position axis grown to ``max_len`` (the
    new positions zeros): dense / moe (L, B, S, KV, hd) and the hybrid's
    attention caches on axis 2, encdec's self caches on axis 2 (its cross
    caches stay), vlm's (G, P-1, B, S, KV, hd) self caches on axis 3;
    rwkv's recurrent state has no position axis."""
    def grow(axis):
        def fn(c):
            shape = list(c.shape)
            shape[axis] = max_len
            out = torch.zeros(shape, dtype=c.dtype, device=c.device)
            out.narrow(axis, 0, c.shape[axis]).copy_(c)
            return out
        return fn

    if family in ("dense", "moe"):
        return tree_map(grow(2), cache)
    if family == "encdec":
        return cache._replace(self_kv=tree_map(grow(2), cache.self_kv))
    if family == "vlm":
        return cache._replace(self_kv=tree_map(grow(3), cache.self_kv))
    if family == "hybrid":
        return cache._replace(attn=tree_map(grow(2), cache.attn))
    return cache


def frontend_inputs(cfg, batch: int, prompt_len: int,
                    gen: torch.Generator, device) -> dict:
    """The stub frontend's embeddings a family's prefill takes (none for
    the token-only families), drawn from ``gen``."""
    if cfg.family == "encdec":
        shape = (batch, prompt_len, cfg.d_model)
    elif cfg.family == "vlm":
        shape = (batch, cfg.n_img_tokens, cfg.d_model)
    else:
        return {}
    key = "src_embed" if cfg.family == "encdec" else "img_embed"
    return {key: torch.randn(shape, generator=gen, device=device).to(
        COMPUTE_DTYPE)}


def serve(arch: str, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, device=None,
          check: int = 0, seed: int = 0) -> dict:
    """Prefill ``batch`` random prompts and decode ``gen`` tokens each;
    returns the run's record (the timings from a synchronized host clock,
    the sampled token ids, ``check``'s largest logit differences)."""
    dev = resolve_device(device)
    use_reference_numerics()
    cfg = ARCHS[arch]
    if reduced:
        cfg = cfg.reduced()
    api = build(cfg)
    gen_key = torch.Generator(device=dev).manual_seed(seed)
    params = init_serving_params(api, gen_key)
    print(f"arch={cfg.arch} params={api.num_params / 1e6:.1f}M "
          f"device={dev}", flush=True)

    b, s = batch, prompt_len
    max_len = s + gen
    tok_key = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=tok_key,
                           device=dev, dtype=torch.int32)
    extras = frontend_inputs(cfg, b, s, tok_key, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    prefill = steps.make_prefill_step(api)
    times = []
    for _ in range(2):      # the first call also loads the device's kernels
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens, **extras})
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    prefill_s = times[1]
    print(f"prefill {b}x{s}: {prefill_s:.3f}s (first call "
          f"{times[0]:.3f}s)", flush=True)
    checked = [logits[:, -1]] if check else []
    cache = grow_cache(cache, max_len, cfg.family)

    out = [next_tok]
    decode = torch.no_grad()(api.decode)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode(params, {"token": next_tok, "pos": s + i},
                               cache)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        if i < check:
            checked.append(logits[:, -1])
        out.append(next_tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = torch.stack(out, dim=1)
    n_steps = max(1, gen - 1)
    rec = {"arch": cfg.arch, "family": cfg.family, "reduced": reduced,
           "device": str(dev),
           "params": api.num_params, "batch": b, "prompt_len": s, "gen": gen,
           "prefill_s": prefill_s, "prefill_first_s": times[0],
           "decode_s": dt,
           "decode_ms_per_step": dt / n_steps * 1e3,
           "decode_tokens_per_s": b * (gen - 1) / dt if dt else None,
           "sample": toks[0, :12].tolist()}
    print(f"decoded {gen - 1} steps x batch {b}: {dt:.3f}s "
          f"({rec['decode_ms_per_step']:.2f} ms/step, "
          f"{rec['decode_tokens_per_s']:.1f} tokens/s)", flush=True)
    print("sample token ids:", rec["sample"], flush=True)
    if check:
        rec["check"] = _check_against_forward(
            params, cfg, tokens, toks[:, :len(checked) - 1], checked, extras)
    if dev.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        print(f"peak device memory {rec['peak_bytes'] / 2**30:.2f} GiB",
              flush=True)
    return rec


def check_config(cfg, n: int):
    """``cfg`` for one forward over ``n`` tokens: attention chunks that
    divide ``n`` (a length such as 1028 would fall back to the gcd, 4, and
    thousands of blocks) and a scan chunk that divides it (the rwkv / Mamba
    scans need one) -- the same math, blocked another way."""
    parts = -(-n // cfg.attn_chunk_q)
    while n % parts:
        parts += 1
    return dataclasses.replace(cfg, attn_chunk_q=n // parts,
                               attn_chunk_kv=n // parts,
                               seq_chunk=math.gcd(cfg.seq_chunk, n))


@torch.no_grad()
def _check_against_forward(params, cfg, prompt, fed, checked,
                           extras: dict) -> dict:
    """Decode-matches-prefill: ``checked[j]`` are the logits after the
    prompt and ``j`` fed tokens; one forward over prompt + fed (and the
    same frontend stub) gives them all.  Raises when one is beyond atol
    0.1 + rtol 0.05."""
    seq = torch.cat([prompt, fed], 1)
    fwd_cfg = check_config(cfg, seq.shape[1])
    mod = family_module(cfg)
    if cfg.family == "encdec":     # the encoder at the prompt's length
        memory = mod.encode(params, extras["src_embed"], cfg)
        full = mod.decoder_forward(params, memory, seq, fwd_cfg)
    elif cfg.family == "vlm":
        full = mod.forward(params, seq, extras["img_embed"], fwd_cfg)
    else:
        full = mod.forward(params, seq, fwd_cfg)
    if isinstance(full, tuple):          # moe: (logits, aux)
        full = full[0]
    s = prompt.shape[1]
    worst, excess = 0.0, 0.0
    for j, got in enumerate(checked):
        want = full[:, s - 1 + j].float()
        diff = (got.float() - want).abs()
        worst = max(worst, float(diff.max()))
        excess = max(excess, float((diff - 0.1 - 0.05 * want.abs()).max()))
    ok = excess <= 0
    print(f"check: {len(checked)} positions (prefill + "
          f"{len(checked) - 1} decode steps) against one forward: max "
          f"|diff| {worst:.4f}, within atol 0.1 + rtol 0.05: {ok}",
          flush=True)
    if not ok:
        raise RuntimeError(f"decode logits differ from the forward's by "
                             f"{worst} (beyond atol 0.1 + rtol 0.05)")
    return {"positions": len(checked), "max_abs_diff": worst}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    ap.add_argument("--check", type=int, default=0,
                    help="hold the first N decode steps to a forward")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    rec = serve(args.arch, args.reduced, args.batch, args.prompt_len,
                args.gen, args.device, args.check)
    print(json.dumps({"serve_llm": rec}), flush=True)
    return rec


if __name__ == "__main__":
    main()
