"""Multi-pod dry run: every (architecture x shape x mesh) cell placed on
the production meshes and stepped once, with no allocation (the port of
``repro.launch.dryrun``).

The process brings up a ``fake`` process group of 256 (``--mesh single``)
or 512 ranks (``multi``) and plays rank 0 of it: its collectives go
nowhere.  The production mesh is built over that group, the cell's
parameters, optimizer state, batch and cache are placed by
``parallel.rules`` as fake tensors (``FakeTensorMode``: shapes, dtypes and
devices, no storage), and the train / prefill / decode step runs once on
them under ``launch.hlo_analysis.OpAnalysis``.  Per cell it records, as
JSON, the reference's keys:

  * ``memory``: per-device ``argument_bytes`` and ``output_bytes`` (the
    local shards' bytes), ``temp_bytes`` (the peak of live storage the step
    allocated) and ``alias_bytes`` (the donated arguments, as the
    reference donates them: the train state, the decode cache);
  * ``flops`` (the per-device dot FLOPs), ``bytes_accessed`` (eager HBM
    bytes), ``collectives`` and ``analyzed`` (``OpAnalysis.record``);
  * ``num_params`` / ``num_active_params``;
  * ``trace_s`` in place of the reference's ``lower_s`` / ``compile_s``:
    eager PyTorch neither lowers nor compiles; the one step's dispatch
    under fake tensors is its trace.

The fake tensors carry the CUDA card's device by default (the card's
host; nothing touches the card's memory); ``--device cpu`` places them on
the CPU.  A failing cell is recorded and counted, as in the reference.

Usage::

  python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out DIR
  python -m repro_torch.launch.dryrun --reduced --device cpu ...   # tests
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCHS
from ..configs.base import SHAPES_BY_NAME, cell_is_runnable
from ..core.engine import resolve_device
from ..models import build, input_specs
from ..models.common import tree_map
from ..optim import adamw
from ..parallel import rules
from ..parallel.constraints import mesh_context
from ..train import steps
from .hlo_analysis import OpAnalysis, tensor_bytes
from .mesh import make_production_mesh


def fake_world(world: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks (one already up at another size is torn down)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _variant(cfg, variant: str):
    if variant == "opt":
        return cfg.optimized()
    if variant.startswith("knob:"):
        # e.g. knob:cast_params_before_scan=True,ce_chunked=512
        kv = {}
        for part in variant[5:].split(","):
            k, v = part.split("=")
            try:
                kv[k] = ast.literal_eval(v)    # ints, floats, bools
            except (ValueError, SyntaxError):
                kv[k] = v                      # a bare string
        return dataclasses.replace(cfg, **kv)
    return cfg


def _placed(specs, shardings, device):
    """Fake tensors of ``specs``' shapes and dtypes at ``shardings``."""
    return tree_map(lambda s, sh: rules.place(
        torch.zeros(s.shape, dtype=s.dtype, device=device), sh), specs,
        shardings)


REDUCED_SEQ = 256      # --reduced: the shapes' sequences cut to this


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "base", device=None,
             reduced: bool = False) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = resolve_device(device)
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev.type)
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": "pod2x16x16" if multi_pod else "pod16x16",
           "n_devices": mesh.size(), "device": dev.type}
    cfg = _variant(ARCHS[arch].reduced() if reduced else ARCHS[arch],
                   variant)
    shape = SHAPES_BY_NAME[shape_name]
    if reduced:
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, REDUCED_SEQ))
        rec["reduced"] = True
    api = build(cfg)
    batch_specs, cache_specs = input_specs(cfg, shape)
    p_sh = rules.param_shardings(api.param_specs, mesh)
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _placed(api.param_specs, p_sh, dev)
        if shape.kind == "decode":
            # the token's position: the cache's last slot
            batch_specs = {"token": batch_specs["token"]}
        batch = _placed(batch_specs, rules.batch_shardings(batch_specs,
                                                           mesh), dev)
        if shape.kind == "train":
            args = (steps.init_train_state(params), batch)
            fn = steps.make_train_step(api, adamw.AdamWConfig())
            alias = tensor_bytes(args[0])
        elif shape.kind == "prefill":
            args = (params, batch)
            fn = steps.make_prefill_step(api)
            alias = 0
        else:
            batch["pos"] = shape.seq_len - 1
            cache = _placed(cache_specs, rules.cache_shardings(
                cache_specs, mesh, shape.global_batch), dev)
            args = (params, batch, cache)
            fn = steps.make_decode_step(api)
            alias = tensor_bytes(cache)
        arg_bytes = tensor_bytes(args)
        with mesh_context(mesh), OpAnalysis() as an:
            out = fn(*args)
        out_bytes = tensor_bytes(out)
        del out, args, params, batch
    rec["trace_s"] = round(time.time() - t0, 2)
    an_rec = an.record()
    rec["memory"] = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                     "temp_bytes": an_rec["peak_bytes"],
                     "alias_bytes": alias}
    rec["flops"] = an_rec["dot_flops"]
    rec["bytes_accessed"] = an_rec["hbm_bytes"]
    rec["collectives"] = {**an_rec["collectives"],
                          "total_bytes": an_rec["collective_bytes"]}
    rec["analyzed"] = an_rec
    full = api if reduced else build(ARCHS[arch])
    rec["num_params"] = full.num_params
    rec["num_active_params"] = full.num_active_params
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="base",
                    help="base | opt | knob:field=value,...")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs, sequences cut to "
                    f"{REDUCED_SEQ} (tests)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card's device; 'cpu' places the "
                    "fake tensors on the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # raises without a card

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = (list(SHAPES_BY_NAME) if (args.all or args.shape is None)
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes
             if cell_is_runnable(ARCHS[a], SHAPES_BY_NAME[s])]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for a, s, mp in cells:
        vtag = ("" if args.variant == "base" else
                "__" + args.variant.replace(":", "-").replace(",", "-")
                .replace("=", "-"))
        tag = f"{a}__{s}__{'multi' if mp else 'single'}{vtag}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"skip {tag}")
            continue
        try:
            rec = run_cell(a, s, mp, variant=args.variant,
                           device=args.device, reduced=args.reduced)
            status = "OK"
        except Exception as e:  # record the failure; the suite goes on
            rec = {"arch": a, "shape": s,
                   "mesh": "multi" if mp else "single",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            status = "FAIL"
            failures += 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        extra = ""
        if status == "OK":
            gb = (rec["memory"]["argument_bytes"]
                  + rec["memory"]["temp_bytes"]) / 2**30
            extra = (f" trace={rec['trace_s']}s mem/dev={gb:.1f}GiB "
                     f"dotflops={rec['analyzed']['dot_flops']:.3g} "
                     f"hbm={rec['analyzed']['hbm_bytes']:.3g} "
                     f"coll={rec['analyzed']['collective_bytes']:.3g}B")
        print(f"{status} {tag}{extra}", flush=True)
    print(f"done: {len(cells)} cells, {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
