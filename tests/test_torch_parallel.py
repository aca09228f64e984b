"""The port's sharding rules, constraints and op analysis against the
reference's, on the CPU.

* Rule parity: every leaf of all ten architectures at full size, on a
  ``(2, 2)`` ``("data", "model")`` and a ``(2, 2, 2)``
  ``("pod", "data", "model")`` mesh: each rank's shard offset and shape
  from DTensor (``compute_local_shape_and_global_offset`` at the port's
  placements) equal the reference's ``devices_indices_map`` of its
  ``NamedSharding``.  The same for ``batch_shardings`` of every cell's
  inputs (the batch of 1 of ``long_500k`` replicated) and for
  ``cache_shardings`` at ``decode_32k``.  The reference runs in a
  subprocess over eight forced host devices; the port's meshes need no
  process group (a ``DeviceMesh`` per rank, built without a backend).
* The batch rule on a ``(16, 16)`` mesh (the port's counterpart of the
  reference's ``test_batch_rule_replicates_batch1``).
* ``constrain``, ``constrain_compute`` and the other hints are the
  identity with no mesh and on plain tensors.
* The analyzer: the torch program of ``tests/test_hlo_analysis.py``'s
  synthetic HLO (12 iterations of an (8, 16) @ (16, 16) and an all-reduce,
  one all-gather) on a fake 4-rank group gives the reference's
  ``analyze(SYNTHETIC_HLO)`` numbers.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro.launch.hlo_analysis import analyze as ref_analyze
from repro_torch.configs import ARCHS
from repro_torch.configs.base import SHAPES_BY_NAME, cell_is_runnable
from repro_torch.models import build, input_specs
from repro_torch.models.common import spec, tree_leaves_with_path
from repro_torch.parallel import constraints, rules

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
from test_hlo_analysis import SYNTHETIC_HLO  # noqa: E402

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}

REFERENCE = """
import json, sys
import jax
import numpy as np
from repro.configs import ARCHS
from repro.configs.base import SHAPES_BY_NAME, cell_is_runnable
from repro.models import build, input_specs
from repro.parallel import rules

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def extents(sh, shape):
    # per rank (mesh positions in row-major order): [offsets, sizes]
    idx = sh.devices_indices_map(tuple(shape))
    out = []
    for d in np.asarray(sh.mesh.devices).reshape(-1):
        sl = idx[d]
        off = [s.start or 0 for s in sl]
        size = [(s.stop if s.stop is not None else n) - (s.start or 0)
                for s, n in zip(sl, shape)]
        out.append([off, size])
    return out


def flat(tree, shard_tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    shs = jax.tree.leaves(shard_tree,
                          is_leaf=lambda x: hasattr(x, "spec"))
    return {rules._path_str(p): extents(s, leaf.shape)
            for (p, leaf), s in zip(leaves, shs)}


res = {}
for mname, (shape, names) in MESHES.items():
    n = int(np.prod(shape))
    mesh = jax.sharding.Mesh(
        np.asarray(jax.devices()[:n]).reshape(shape), names)
    for arch, cfg in ARCHS.items():
        api = build(cfg)
        res[f"{mname}/{arch}/params"] = flat(
            api.param_specs, rules.param_shardings(api.param_specs, mesh))
        for sname, sh in SHAPES_BY_NAME.items():
            if not cell_is_runnable(cfg, sh):
                continue
            batch, cache = input_specs(cfg, sh)
            res[f"{mname}/{arch}/batch/{sname}"] = flat(
                batch, rules.batch_shardings(batch, mesh))
            if sname == "decode_32k":
                res[f"{mname}/{arch}/cache"] = flat(
                    cache, rules.cache_shardings(cache, mesh,
                                                 sh.global_batch))
with open(sys.argv[1], "w") as f:
    json.dump(res, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("rules") / "extents.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out)], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


def _meshes(mname):
    """One mesh per rank, no process group: the rank fixes the mesh
    coordinate DTensor's shard extents are computed at."""
    shape, names = MESHES[mname]
    n = int(np.prod(shape))
    return [DeviceMesh("cpu", torch.arange(n).reshape(shape),
                       mesh_dim_names=names, _init_backend=False, _rank=r)
            for r in range(n)]


def _extents(specs, shard_fn, meshes):
    """{path: per rank [offsets, sizes]} of the port's placements."""
    per_rank = []
    for m in meshes:
        leaves = tree_leaves_with_path(specs)
        shs = [s for _, s in tree_leaves_with_path(shard_fn(specs, m))]
        per_rank.append({
            p: compute_local_shape_and_global_offset(
                leaf.shape, m, sh.placements)
            for (p, leaf), sh in zip(leaves, shs)})
    return {p: [[list(r[p][1]), list(r[p][0])] for r in per_rank]
            for p in per_rank[0]}


def _ref_paths(ref: dict) -> dict:
    # the reference names NamedTuple fields by index, the port by name:
    # compare in flattening order
    return list(ref.values())


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_extents_match_reference(reference, arch, mname):
    cfg = ARCHS[arch]
    api = build(cfg)
    got = _extents(api.param_specs, rules.param_shardings, _meshes(mname))
    want = reference[f"{mname}/{arch}/params"]
    assert sorted(got) == sorted(want), arch
    for path in want:
        assert got[path] == want[path], (arch, mname, path)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_cache_extents_match_reference(reference, arch, mname):
    cfg = ARCHS[arch]
    meshes = _meshes(mname)
    for sname, sh in SHAPES_BY_NAME.items():
        if not cell_is_runnable(cfg, sh):
            continue
        batch, cache = input_specs(cfg, sh)
        got = _extents(batch, rules.batch_shardings, meshes)
        want = reference[f"{mname}/{arch}/batch/{sname}"]
        assert got == want, (arch, mname, sname)
        if sname == "decode_32k":
            got = _extents(cache, lambda c, m: rules.cache_shardings(
                c, m, sh.global_batch), meshes)
            want = reference[f"{mname}/{arch}/cache"]
            assert list(got.values()) == _ref_paths(want), (arch, mname)


def test_batch_rule_replicates_batch1_on_production_mesh():
    """The port's counterpart of the reference's
    ``test_batch_rule_replicates_batch1`` (an ``AbstractMesh`` of (16,
    16)): a batch of 1 is replicated, a batch of 128 goes over "data"."""
    mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                      mesh_dim_names=("data", "model"), _init_backend=False,
                      _rank=0)
    b = {"token": spec(1, dtype=torch.int32),
         "tokens": spec(128, 64, dtype=torch.int32)}
    sh = rules.batch_shardings(b, mesh)
    assert sh["token"].spec == (None,)
    assert all(p.is_replicate() for p in sh["token"].placements)
    assert sh["tokens"].spec[0] in ("data", ("data",))
    assert [str(p) for p in sh["tokens"].placements] == ["S(0)", "R"]
    # the cache rule: batch at dim 1, "model" on the largest divisible dim
    cache = spec(36, 128, 32768, 8, 128, dtype=torch.bfloat16)
    s = rules.cache_shardings(cache, mesh, batch_size=128).spec
    assert s[1] is not None and s[2] == "model"


def test_param_rules_cover_all_archs():
    mesh = _meshes("2x2")[0]
    for arch, cfg in ARCHS.items():
        api = build(cfg)
        sh = rules.param_shardings(api.param_specs, mesh)
        assert len(tree_leaves_with_path(sh)) == len(
            tree_leaves_with_path(api.param_specs)), arch
        assert sh["embed"].spec[0] == "model"


def test_hints_are_identities_without_a_mesh():
    """With no mesh entered, and on plain tensors under one, every hint
    returns its argument itself: the one-device paths keep their bits."""
    x = torch.randn(2, 3, 4)
    assert constraints.current_mesh() is None
    assert constraints.constrain(x, constraints.BATCH, None, None) is x
    assert constraints.constrain(x, constraints.BATCH, None,
                                 constraints.MODEL) is x
    for fn in (constraints.replicate, constraints.unshard_middle,
               constraints.rows, lambda t: constraints.unshard(t, 1)):
        assert fn(x) is x
    tree = {"attn": {"wq": torch.randn(4, 8)}, "w1": torch.randn(4, 8)}
    assert rules.constrain_compute(tree) is tree
    mesh = _meshes("2x2")[0]
    with mesh:
        assert constraints.current_mesh() is mesh
        assert constraints.constrain(x, constraints.BATCH, None, None) is x
        out = rules.constrain_compute(tree)
        assert out["attn"]["wq"] is tree["attn"]["wq"]
    assert constraints.current_mesh() is None
    assert constraints.local_map(lambda a: a * 2, (x,), [(0, None)],
                                 [(0, None)]).equal(x * 2)


SYNTHETIC = """
import json, sys
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.hlo_analysis import OpAnalysis

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
g = dist.group.WORLD
a, w = torch.ones(8, 16), torch.ones(16, 16)
with OpAnalysis() as an:
    x = a
    for _ in range(12):               # the while loop: 12 trips
        x = funcol.all_reduce(x @ w, "sum", g)
    gathered = funcol.all_gather_tensor(a[:2], 0, g) + 0
print(json.dumps(an.record()))
"""


def test_op_analysis_matches_reference_on_synthetic_program():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", SYNTHETIC], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    want = ref_analyze(SYNTHETIC_HLO)
    assert got["dot_flops"] == want["dot_flops"] == 49152
    for kind, (count, nbytes) in {"all-reduce": (12, 12288),
                                  "all-gather": (1, 512)}.items():
        assert got["collectives"][kind]["count"] == \
            want["collectives"][kind]["count"] == count
        assert got["collectives"][kind]["bytes"] == \
            want["collectives"][kind]["bytes"] == nbytes
    assert got["collective_bytes"] == want["collective_bytes"] == 12800
    assert "tpu_bytes" not in got and got["hbm_bytes"] > 0
