"""End-to-end driver on the PyTorch port: train a ~100M-param LM for a few
hundred steps (the port of ``examples/train_lm.py``).

Uses the same ModelAPI / train-step / data / checkpoint stack as the
training launcher, on one device.  Loss on the synthetic motif language
drops from ~ln(V) to near the motif entropy within a few hundred steps.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]  # card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
        --layers 2 --d-model 64 --vocab 512 --seq-len 32 --steps 30

The size arguments default to the reference example's model (8 layers,
d_model 768, 12 heads, d_ff 2048, vocab 32,000, 256 tokens, batch 8).
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.ckpt import checkpoint
from repro_torch.configs import ARCHS
from repro_torch.core.engine import resolve_device
from repro_torch.data import pipeline
from repro_torch.models import build, init_params
from repro_torch.models.common import use_reference_numerics
from repro_torch.optim import adamw
from repro_torch.train import steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--d-ff", type=int, default=2048)
    ap.add_argument("--vocab", type=int, default=32_000)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    use_reference_numerics()

    # ~100M params at the defaults: the stablelm family scaled down
    chunk = min(256, args.seq_len)
    cfg = dataclasses.replace(
        ARCHS["stablelm-1.6b"], n_layers=args.layers, d_model=args.d_model,
        n_heads=args.heads, n_kv_heads=args.heads, d_ff=args.d_ff,
        vocab=args.vocab, attn_chunk_q=chunk, attn_chunk_kv=chunk)
    api = build(cfg)
    print(f"model: {api.num_params / 1e6:.1f}M params on {dev}")

    params = init_params(api, torch.Generator(device=dev).manual_seed(0))
    state = steps.init_train_state(params)
    opt_cfg = adamw.AdamWConfig(lr=6e-4, warmup_steps=30,
                                total_steps=args.steps, weight_decay=0.1)
    train_step = steps.make_train_step(api, opt_cfg)
    data_cfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                   global_batch=args.batch, seed=0)

    start = checkpoint.latest_step(args.ckpt_dir) or 0
    if start:
        state = checkpoint.restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipeline.batch_at(data_cfg, step).items()}
        state, stats = train_step(state, batch)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss={float(stats['loss']):.4f}  "
                  f"gnorm={float(stats['grad_norm']):.2f}  "
                  f"lr={float(stats['lr']):.2e}  "
                  f"({(time.time() - t0):.0f}s)")
        if (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1, state)
            checkpoint.gc_old(args.ckpt_dir, keep=2)
    print("done")


if __name__ == "__main__":
    main()
