"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

One reduced cell of each kind -- train, prefill, decode -- runs in a
subprocess as rank 0 of a fake process group of 256 ranks, on the
``(16, 16)`` production mesh, with ``--device cpu``.  Each record has the
reference's keys (``src/repro/launch/dryrun.py``), with ``trace_s`` in
place of ``lower_s`` / ``compile_s`` / ``analyze_s`` and no ``tpu_bytes``;
``argument_bytes`` equals the local shard bytes of every argument,
counted here from the rules' placements (rank 0's extents); the dot
FLOPs, HBM bytes and peak are positive, and a train cell runs
collectives.  The import test (``tests/test_torch_engine.py``) walks
every module of the port, ``parallel/``, ``launch/dryrun.py`` and
``launch/hlo_analysis.py`` among them.
"""
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.configs import ARCHS
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.launch import dryrun
from repro_torch.models import build, input_specs
from repro_torch.models.common import tree_leaves, tree_leaves_with_path
from repro_torch.optim import adamw
from repro_torch.parallel import rules

REPO = Path(__file__).resolve().parents[1]
CELLS = [("stablelm-1.6b", "train_4k"), ("qwen3-moe-235b-a22b",
                                         "prefill_32k"),
         ("rwkv6-1.6b", "decode_32k")]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    recs = {}
    for arch, shape in CELLS:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--reduced", "--device", "cpu",
             "--out", str(out)], env=env, cwd=REPO, capture_output=True,
            text=True, timeout=600)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
        assert f"OK {arch}__{shape}__single" in r.stdout
        recs[shape] = json.loads(
            (out / f"{arch}__{shape}__single.json").read_text())
    return recs


def _reference_keys() -> set:
    src = (REPO / "src/repro/launch/dryrun.py").read_text()
    keys = set(re.findall(r'rec\["(\w+)"\]', src))
    keys |= {"arch", "shape", "variant", "mesh", "n_devices"}
    return keys


def _rank0_bytes(specs, shardings) -> int:
    mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                      mesh_dim_names=("data", "model"), _init_backend=False,
                      _rank=0)
    total = 0
    sh = [s for _, s in tree_leaves_with_path(shardings(mesh))]
    for leaf, s in zip(tree_leaves(specs), sh):
        local, _ = compute_local_shape_and_global_offset(
            leaf.shape, mesh, s.placements)
        total += math.prod(local) * torch.empty(
            (), dtype=leaf.dtype).element_size()
    return total


@pytest.mark.parametrize("arch,shape", CELLS)
def test_record_has_reference_keys(records, arch, shape):
    rec = records[shape]
    want = _reference_keys() - {"lower_s", "compile_s", "analyze_s"}
    assert want <= set(rec), want - set(rec)
    assert rec["trace_s"] > 0 and rec["n_devices"] == 256
    assert rec["mesh"] == "pod16x16" and rec["reduced"]
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    an = rec["analyzed"]
    assert {"dot_flops", "hbm_bytes", "bytes_by_op", "collectives",
            "collective_bytes"} <= set(an)
    assert "tpu_bytes" not in an
    assert an["dot_flops"] > 0 and an["hbm_bytes"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["flops"] == an["dot_flops"]
    assert rec["collectives"]["total_bytes"] == an["collective_bytes"]
    api = build(ARCHS[arch].reduced())
    assert rec["num_params"] == api.num_params


def test_train_cell_argument_bytes_are_local_shards(records):
    """Params, m and v at the param rules, the two step counters, the
    batch at the batch rules: rank 0's local bytes."""
    cfg = ARCHS["stablelm-1.6b"].reduced()
    api = build(cfg)
    shape = SHAPES_BY_NAME["train_4k"]
    shape = type(shape)(shape.name, dryrun.REDUCED_SEQ, shape.global_batch,
                        shape.kind)
    batch, _ = input_specs(cfg, shape)
    p = _rank0_bytes(api.param_specs,
                     lambda m: rules.param_shardings(api.param_specs, m))
    opt = adamw.state_specs(api.param_specs)
    mv = _rank0_bytes(opt.m, lambda m: rules.param_shardings(
        api.param_specs, m))
    b = _rank0_bytes(batch, lambda m: rules.batch_shardings(batch, m))
    rec = records["train_4k"]
    assert rec["memory"]["argument_bytes"] == p + 2 * mv + 2 * 4 + b
    assert rec["memory"]["alias_bytes"] == p + 2 * mv + 2 * 4
    # ZeRO-3 + TP: one rank holds a 256th of the params, not all of them
    assert p < api.num_params * 4 / 64
    assert rec["analyzed"]["collective_bytes"] > 0


def test_decode_cell_donates_the_cache(records):
    """The decode cell counts its cache (the rwkv state) as donated, as
    the reference donates it, and returns the new one."""
    rec = records["decode_32k"]
    assert rec["memory"]["alias_bytes"] > 0
    assert rec["memory"]["output_bytes"] >= rec["memory"]["alias_bytes"]


def test_mesh_entry_points_raise_without_card(monkeypatch):
    """The dry run and the meshes run on the card unless asked for the
    CPU: without one they raise before touching a process group."""
    from repro_torch.launch import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: dryrun.main(["--arch", "stablelm-1.6b", "--shape",
                                      "train_4k"]),
                 lambda: mesh.make_host_mesh(),
                 lambda: mesh.make_production_mesh()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
