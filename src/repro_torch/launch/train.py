"""Training launcher (the port of ``repro.launch.train``).

Builds the requested mesh, places the train state by the sharding rules
(``parallel.rules.param_shardings``; the batch by ``batch_shardings``)
and runs the supervised loop -- atomic checkpoints, crash-restart,
straggler flagging -- on the port's ``TrainSupervisor``, each step under
the mesh (``parallel.constraints.mesh_context``).  It runs on the CUDA
card unless ``--device cpu`` asks for the CPU::

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --steps 4 --seq-len 4096 --global-batch 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 20 --global-batch 4 --seq-len 64

The encdec and vlm families train on the frontend stub's embeddings
(``pipeline.frontend_stub``, in bf16), as the reference's.
``--mesh host`` is ``make_host_mesh()``: ``(world, 1)`` over the process
group, ``(1, 1)`` for one process.  ``single`` and ``multi`` are the
production meshes (``(16, 16)`` and ``(2, 16, 16)``), which need 256 and
512 processes (one per card, the group initialised by the caller, e.g.
``torchrun``) and raise ``ValueError`` on fewer.  Every rank draws the
same parameters from the seed, leaf by leaf, and keeps its pieces of
each.  Each step's
wall time is taken after a device synchronize; the last line of the
output is a JSON record of the run (the mesh's shape, step times, losses,
tokens/s, peak device memory, the checkpoints' save seconds and size).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from ..configs import ARCHS
from ..configs.base import ShapeConfig
from ..core.engine import resolve_device
from ..data import pipeline
from ..models import build
from ..models.common import (init_from_specs, tree_leaves_with_path,
                             use_reference_numerics)
from ..optim import adamw
from ..parallel import rules
from ..parallel.constraints import is_dtensor, mesh_context
from ..runtime import SupervisorConfig, TrainSupervisor
from ..train import steps
from .mesh import make_host_mesh, make_production_mesh


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _scalar(x) -> float:
    return float(x.full_tensor() if is_dtensor(x) else x)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="use ModelConfig.optimized() perf variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default="host")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = (make_host_mesh(device=args.device) if args.mesh == "host" else
            make_production_mesh(multi_pod=args.mesh == "multi",
                                 device=args.device))
    use_reference_numerics()
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    if args.optimized:
        cfg = cfg.optimized()
    api = build(cfg)
    print(f"arch={cfg.arch} params={api.num_params / 1e6:.1f}M "
          f"(active {api.num_active_params / 1e6:.1f}M)", flush=True)
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    print(f"mesh: {mesh_shape} on {dev}", flush=True)

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(
        30, args.steps // 10 + 1), total_steps=args.steps)
    data_cfg = pipeline.DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                   global_batch=args.global_batch)

    # drawn leaf by leaf, each placed at once: a rank holds its pieces and
    # one whole leaf at most
    p_sh = dict(tree_leaves_with_path(rules.param_shardings(api.param_specs,
                                                            mesh)))
    params = init_from_specs(
        api.param_specs, torch.Generator(device=dev).manual_seed(0),
        finish=lambda path, leaf: rules.place(leaf, p_sh[path]))
    state = steps.init_train_state(params)
    del params
    train_step = steps.make_train_step(api, opt_cfg)

    shape = ShapeConfig("train", args.seq_len, args.global_batch, "train")

    def batch_fn(step):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in pipeline.batch_at(data_cfg, step).items()}
        extras = pipeline.frontend_stub(cfg, shape, step)
        if extras is not None:      # encdec / vlm: the frontend's stub
            key = "src_embed" if cfg.family == "encdec" else "img_embed"
            b[key] = torch.from_numpy(extras).to(dev, torch.bfloat16)
        return rules.shard_tree(b, rules.batch_shardings(b, mesh))

    sup = TrainSupervisor(
        SupervisorConfig(ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every), state)
    if sup.start_step:
        print(f"resumed from step {sup.start_step}", flush=True)
    del state
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    log = {"step_s": [], "loss": [], "grad_norm": []}

    def logged_step(st, batch):
        t_step = time.perf_counter()
        st, stats = train_step(st, batch)
        loss, gnorm = _scalar(stats["loss"]), _scalar(stats["grad_norm"])
        log["step_s"].append(time.perf_counter() - t_step)
        log["loss"].append(loss)
        log["grad_norm"].append(gnorm)
        step = int(st.step)
        if step % 10 == 0 or step == args.steps:
            print(f"step {step:5d} loss={loss:.4f} gnorm={gnorm:.2f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        return st, stats

    with mesh_context(mesh):
        sup.run(logged_step, batch_fn, args.steps)
    if sup.flagged_steps:
        print(f"straggler steps flagged: {sup.flagged_steps}")
    tokens = args.global_batch * args.seq_len
    timed = log["step_s"][1:] or log["step_s"]
    rec = {"arch": cfg.arch, "reduced": args.reduced, "device": str(dev),
           "mesh": mesh_shape, "params": api.num_params, "steps": args.steps,
           "start_step": sup.start_step, "tokens_per_step": tokens,
           **log, "saves": sup.saves}
    if timed:
        ms = sorted(timed)[len(timed) // 2] * 1e3
        rec.update(ms_per_step=ms, tokens_per_s=tokens / ms * 1e3)
        print(f"{len(log['step_s'])} steps: {ms:.1f} ms/step (median after "
              f"the first), {rec['tokens_per_s']:.0f} tokens/s", flush=True)
    final = os.path.join(args.ckpt_dir, f"step_{args.steps:08d}")
    rec["ckpt_bytes"] = _dir_bytes(final)
    print(f"checkpoint {final}: {rec['ckpt_bytes'] / 1e9:.3f} GB saved in "
          f"{sup.saves[-1][1]:.2f}s", flush=True)
    if dev.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        print(f"peak device memory {rec['peak_bytes'] / 2**30:.2f} GiB",
              flush=True)
    if log["loss"]:
        print(f"done: final loss {log['loss'][-1]:.4f}", flush=True)
    print(json.dumps({"train": rec}), flush=True)
    return rec


if __name__ == "__main__":
    main()
