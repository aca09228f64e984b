"""The LLM side on a 2-D mesh of 4 gloo ranks against the reference's host
mesh of 4 forced devices and against the port's one-device step.

* One train step of reduced stablelm-1.6b and of reduced qwen3-moe on a
  ``(2, 2)`` ``("data", "model")`` mesh (``make_host_mesh(2)``), from the
  same numpy-made parameters and the pipeline's batch: loss and grad norm
  within rtol 1e-3 of the reference's step on its ``(2, 2)`` host mesh,
  the first moments (the clipped gradients) within rtol 2e-2 and every
  parameter within an AdamW sign flip (``torch_g3.step_agrees``); and
  the same against the port's one-device step, the loss within rtol
  1e-4 (for the MoE, the routed leaves against the reference only: a
  token near a routing tie may take another expert).
* The GSPMD knobs: the step with ``optimized()`` and the four mesh knobs
  on (``cast_params_before_scan``, ``gather_weights``,
  ``residual_sharding="replicated"``, ``attn_replicate``) equals the base
  step (loss rel 2e-2, grad norm rel 5e-2, as
  ``tests/test_perf_variants.py`` holds the reference), and
  ``residual_sharding="seq"`` too.
* On a ``(1, 4)`` mesh, where "model" splits the query heads but not the
  KV heads, the same step against one device.
* Three decode steps of reduced stablelm against a cache placed by
  ``cache_shardings`` (its sequence over "model") equal one device's
  logits within atol 5e-2.
* One forward loss of reduced rwkv6, zamba2, seamless-m4t and
  llama-vision on the mesh equals the one-device loss (rtol 1e-4).
* A supervised run on the mesh killed at step 3 and restarted from its
  step-2 checkpoint ends bit-identical to the uninterrupted run.
* The launcher on the 4 ranks: ``--mesh host`` is ``(4, 1)``, runs two
  steps and checkpoints; ``--mesh single`` raises "need 256 devices".

The port runs SPMD through ``torch_spawn.run_world``; the reference runs
the same steps jitted in its subprocess.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_g3 import DATA, OPT, numpy_leaves, step_agrees
from torch_spawn import run_world

WORLD = 4
TIMEOUT = 420
TRAIN_ARCHS = ("stablelm-1.6b", "qwen3-moe-235b-a22b")
FORWARD_ARCHS = ("rwkv6-1.6b", "zamba2-7b", "seamless-m4t-large-v2",
                 "llama-3.2-vision-11b")

REFERENCE = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, "tests")
from torch_g3 import DATA, OPT, numpy_leaves
from repro.configs import ARCHS
from repro.data import pipeline
from repro.launch.mesh import make_host_mesh
from repro.models import build
from repro.optim import adamw
from repro.parallel import rules
from repro.train import steps

out = sys.argv[2]
mesh = make_host_mesh(model_axis=2)
assert mesh.devices.shape == (2, 2), mesh
res = {}
for arch in sys.argv[3:]:
    cfg = ARCHS[arch].reduced()
    api = build(cfg)
    leaves, tdef = jax.tree_util.tree_flatten_with_path(api.param_specs)
    host = numpy_leaves([(rules._path_str(p), s.shape) for p, s in leaves])
    with mesh:
        params = jax.tree.map(
            jax.device_put, jax.tree.unflatten(tdef, host),
            rules.param_shardings(api.param_specs, mesh))
        batch = jax.tree.map(jnp.asarray, pipeline.batch_at(
            pipeline.DataConfig(vocab=cfg.vocab, **DATA), 0))
        batch = jax.tree.map(jax.device_put, batch,
                             rules.batch_shardings(batch, mesh))
        step = jax.jit(steps.make_train_step(api, adamw.AdamWConfig(**OPT)))
        state, st = step(steps.init_train_state(params), batch)
    res[arch + "/stats"] = np.array([float(st["loss"]),
                                     float(st["grad_norm"])])
    for i, p in enumerate(jax.tree.leaves(jax.device_get(state.params))):
        res[f"{arch}/p{i}"] = np.asarray(p, np.float32)
    for i, m in enumerate(jax.tree.leaves(jax.device_get(state.opt.m))):
        res[f"{arch}/m{i}"] = np.asarray(m, np.float32)
np.savez(out, **res)
"""


def _params(api):
    from repro_torch.models.common import tree_leaves_with_path, \
        tree_unflatten
    leaves = tree_leaves_with_path(api.param_specs)
    host = numpy_leaves([(p, s.shape) for p, s in leaves])
    return tree_unflatten(api.param_specs,
                          [torch.from_numpy(a) for a in host]), host


def _batch(cfg, dev="cpu"):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    b = {k: torch.from_numpy(v) for k, v in pipeline.batch_at(
        pipeline.DataConfig(vocab=cfg.vocab, **DATA), 0).items()}
    shape = ShapeConfig("train", DATA["seq_len"], DATA["global_batch"],
                        "train")
    extras = pipeline.frontend_stub(cfg, shape, 0)
    if extras is not None:
        key = "src_embed" if cfg.family == "encdec" else "img_embed"
        b[key] = torch.from_numpy(extras).to(torch.bfloat16)
    return b


def _full(x):
    from repro_torch.parallel.constraints import is_dtensor
    return (x.full_tensor() if is_dtensor(x) else x).detach().float()


def _step(cfg, mesh):
    """One train step from the numpy parameters: (loss, grad norm),
    params and first moments -- on ``mesh``, or on one device for
    ``None``."""
    from repro_torch.models import build
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import rules
    from repro_torch.parallel.constraints import mesh_context
    from repro_torch.train import steps
    api = build(cfg)
    params, _ = _params(api)
    batch = _batch(cfg)
    if mesh is not None:
        params = rules.shard_tree(params, rules.param_shardings(
            api.param_specs, mesh))
        batch = rules.shard_tree(batch, rules.batch_shardings(batch, mesh))
    step = steps.make_train_step(api, adamw.AdamWConfig(**OPT))
    with mesh_context(mesh):
        state, st = step(steps.init_train_state(params), batch)
        return (np.array([float(_full(st["loss"])),
                          float(_full(st["grad_norm"]))]),
                [_full(p).numpy() for p in tree_leaves(state.params)],
                [_full(m).numpy() for m in tree_leaves(state.opt.m)])


def _forward(cfg, mesh):
    from repro_torch.models import build
    from repro_torch.parallel import rules
    from repro_torch.parallel.constraints import mesh_context
    api = build(cfg)
    params, _ = _params(api)
    batch = _batch(cfg)
    if mesh is not None:
        params = rules.shard_tree(params, rules.param_shardings(
            api.param_specs, mesh))
        batch = rules.shard_tree(batch, rules.batch_shardings(batch, mesh))
    with torch.no_grad(), mesh_context(mesh):
        return float(_full(api.loss(params, batch)))


def _decode(cfg, mesh, steps: int = 3) -> np.ndarray:
    """``steps`` decode steps of the pipeline's tokens from an empty cache
    of 64 positions (on a mesh placed by ``rules.cache_shardings``: the
    sequence over "model"): the logits of each step."""
    from repro_torch.models import build
    from repro_torch.parallel import rules
    from repro_torch.parallel.constraints import mesh_context
    api = build(cfg)
    params, _ = _params(api)
    tokens = _batch(cfg)["tokens"]
    b = tokens.shape[0]
    cache = api.cache_specs(b, 64)
    cache = type(cache)(*(torch.zeros(s.shape, dtype=s.dtype)
                          for s in cache))
    if mesh is not None:
        params = rules.shard_tree(params, rules.param_shardings(
            api.param_specs, mesh))
        cache = rules.shard_tree(cache, rules.cache_shardings(
            api.cache_specs(b, 64), mesh, b))
    out = []
    with torch.no_grad(), mesh_context(mesh):
        for pos in range(steps):
            token = tokens[:, pos]
            if mesh is not None:
                token = rules.shard_tree(
                    token, rules.batch_shardings(token, mesh))
            logits, cache = api.decode(params, {"token": token, "pos": pos},
                                       cache)
            out.append(_full(logits).numpy())
    return np.stack(out)


def _restart(cfg, mesh, ckpt: str) -> bool:
    """A supervised run killed at step 3 and resumed from its step-2
    checkpoint ends bit-identical to the uninterrupted run."""
    from repro_torch.data import pipeline
    from repro_torch.models import build
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import rules
    from repro_torch.parallel.constraints import mesh_context
    from repro_torch.runtime import SupervisorConfig, TrainSupervisor
    from repro_torch.train import steps
    api = build(cfg)
    data = pipeline.DataConfig(vocab=cfg.vocab, **DATA)
    step = steps.make_train_step(api, adamw.AdamWConfig(**OPT))

    def fresh():
        params, _ = _params(api)
        return steps.init_train_state(rules.shard_tree(
            params, rules.param_shardings(api.param_specs, mesh)))

    def batch_fn(i):
        b = {k: torch.from_numpy(v)
             for k, v in pipeline.batch_at(data, i).items()}
        return rules.shard_tree(b, rules.batch_shardings(b, mesh))

    with mesh_context(mesh):
        whole = TrainSupervisor(SupervisorConfig(ckpt + "/a", 2), fresh()
                                ).run(step, batch_fn, 4)
        sup = TrainSupervisor(SupervisorConfig(ckpt + "/b", 2), fresh())
        try:
            sup.run(step, batch_fn, 4, crash_at=3)
        except RuntimeError:
            pass
        again = TrainSupervisor(SupervisorConfig(ckpt + "/b", 2), fresh())
        assert again.start_step == 2
        resumed = again.run(step, batch_fn, 4)
    return all(torch.equal(_full(a), _full(b)) for a, b in zip(
        tree_leaves(whole), tree_leaves(resumed)))


def _worker(rank: int, world: int, store: str, out: str) -> None:
    import os
    import torch.distributed as dist

    from repro_torch.configs import ARCHS
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(model_axis=2, device="cpu")
        res = {"mesh": np.array(mesh.mesh.shape)}
        for arch in TRAIN_ARCHS:
            cfg = ARCHS[arch].reduced()
            for tag, on in (("", mesh), ("/one", None)):
                res[f"{arch}{tag}/stats"], params, moments = _step(cfg, on)
                for i, (p, m) in enumerate(zip(params, moments)):
                    res[f"{arch}{tag}/p{i}"] = p
                    res[f"{arch}{tag}/m{i}"] = m
            knobs = dataclasses.replace(
                cfg.optimized(), cast_params_before_scan=True,
                gather_weights=True, residual_sharding="replicated",
                attn_replicate=True)
            res[arch + "/knobs/stats"] = _step(knobs, mesh)[0]
            seq = dataclasses.replace(cfg, residual_sharding="seq")
            res[arch + "/seq/stats"] = _step(seq, mesh)[0]
        # (1, 4): "model" splits the 4 query heads, not the 2 KV heads
        wide = make_host_mesh(model_axis=4, device="cpu")
        cfg = ARCHS["stablelm-1.6b"].reduced()
        res["wide/stats"], params, moments = _step(cfg, wide)
        for i, (p, m) in enumerate(zip(params, moments)):
            res[f"wide/p{i}"] = p
            res[f"wide/m{i}"] = m
        cfg = ARCHS["stablelm-1.6b"].reduced()
        res["decode"] = np.stack([_decode(cfg, mesh), _decode(cfg, None)])
        for arch in FORWARD_ARCHS:
            cfg = ARCHS[arch].reduced()
            res[arch + "/forward"] = np.array([_forward(cfg, mesh),
                                               _forward(cfg, None)])
        base = os.path.dirname(out)
        res["restart_bitwise"] = np.array(_restart(
            ARCHS["stablelm-1.6b"].reduced(), mesh, base + "/restart"))
        argv = ["--device", "cpu", "--reduced", "--global-batch", "4",
                "--seq-len", "32", "--steps", "2", "--ckpt-dir",
                base + "/launcher", "--ckpt-every", "2"]
        rec = train.main(argv)
        res["launcher/mesh"] = np.array([rec["mesh"]["data"],
                                         rec["mesh"]["model"]])
        res["launcher/loss"] = np.array(rec["loss"])
        res["launcher/ckpt_bytes"] = np.array(rec["ckpt_bytes"])
        try:
            train.main(argv + ["--mesh", "single"])
            res["launcher/single"] = np.array("no error")
        except ValueError as e:
            res["launcher/single"] = np.array(str(e))
        np.savez(out % rank, **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data, port = run_world(tmp_path_factory.mktemp("mesh"), WORLD, _worker,
                           REFERENCE, list(TRAIN_ARCHS), TIMEOUT)
    return dict(np.load(data)), [dict(np.load(port % r))
                                 for r in range(WORLD)]


def _n_leaves(res, prefix):
    return sum(1 for k in res if k.startswith(prefix + "/p"))


# a token near a routing tie may take another expert when bf16 rounds in
# another order: its gradient then moves between experts (by 10-14% of
# an expert's gradient on reduced qwen3-moe's layer 1 against one
# device).  The routed leaves are held to the reference's mesh step;
# against one device, the loss, the grad norm and every other leaf.
ROUTED = ("exp_w1", "exp_w2", "exp_w3", "router", "mlp_norm")


def _agree(got, want, arch, skip=()):
    """Every leaf of one step agrees (``torch_g3.step_agrees``) but those
    named in ``skip``."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    from repro_torch.models.common import tree_leaves_with_path
    from repro_torch.optim import adamw
    api = build(ARCHS[arch].reduced())
    _, p0 = _params(api)
    names = [p.split("/")[-1] for p, _ in tree_leaves_with_path(
        api.param_specs)]
    lr = float(adamw.schedule(adamw.AdamWConfig(**OPT), torch.tensor(1)))
    g, w = got.split("|"), want.split("|")
    n = len(p0)
    assert _n_leaves(RES[g[0]], g[1]) == _n_leaves(RES[w[0]], w[1]) == n
    held = 0
    for i in range(n):
        if names[i] in skip:
            continue
        held += 1
        assert step_agrees(RES[g[0]][f"{g[1]}/p{i}"], RES[w[0]][f"{w[1]}/p{i}"],
                           p0[i], RES[g[0]][f"{g[1]}/m{i}"],
                           RES[w[0]][f"{w[1]}/m{i}"], lr), (arch, names[i])
    assert held >= 7


RES = {}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_step_matches_reference(runs, arch):
    ref, ranks = runs
    RES.update(ref=ref, port=ranks[0])
    got = ranks[0]
    assert tuple(got["mesh"]) == (2, 2)
    loss, gnorm = got[arch + "/stats"]
    rloss, rgnorm = ref[arch + "/stats"]
    assert loss == pytest.approx(rloss, rel=1e-3)
    assert gnorm == pytest.approx(rgnorm, rel=1e-3)
    _agree(f"port|{arch}", f"ref|{arch}", arch)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_step_matches_one_device(runs, arch):
    _, ranks = runs
    RES.update(port=ranks[0])
    for got in ranks:        # every rank holds the same replicated stats
        np.testing.assert_array_equal(got[arch + "/stats"],
                                      ranks[0][arch + "/stats"])
    got = ranks[0]
    (loss, gnorm), (oloss, ognorm) = got[arch + "/stats"], \
        got[arch + "/one/stats"]
    assert loss == pytest.approx(oloss, rel=1e-4)
    assert gnorm == pytest.approx(ognorm, rel=1e-3)
    _agree(f"port|{arch}", f"port|{arch}/one", arch,
           skip=ROUTED if "moe" in arch else ())


def test_query_head_split_matches_one_device(runs):
    """On a (1, 4) mesh "model" divides reduced stablelm's 4 query heads,
    not its 2 KV heads: each rank attends with its query head and that
    head's KV head."""
    got = runs[1][0]
    RES.update(port=got)
    (loss, gnorm), (oloss, ognorm) = got["wide/stats"], \
        got["stablelm-1.6b/one/stats"]
    assert loss == pytest.approx(oloss, rel=1e-4)
    assert gnorm == pytest.approx(ognorm, rel=1e-3)
    _agree("port|wide", "port|stablelm-1.6b/one", "stablelm-1.6b")


@pytest.mark.parametrize("variant", ["knobs", "seq"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_knobs_match_base_step(runs, arch, variant):
    got = runs[1][0]
    (loss, gnorm), (bloss, bgnorm) = got[f"{arch}/{variant}/stats"], \
        got[arch + "/stats"]
    assert loss == pytest.approx(bloss, rel=2e-2)
    assert gnorm == pytest.approx(bgnorm, rel=5e-2)


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_mesh_forward_matches_one_device(runs, arch):
    mesh_loss, one_loss = runs[1][0][arch + "/forward"]
    assert np.isfinite(one_loss)
    assert mesh_loss == pytest.approx(one_loss, rel=1e-4)


def test_mesh_decode_matches_one_device(runs):
    """Decode steps against a cache whose sequence "model" splits: each
    rank writes and scores its own positions (flash-decode), equal to one
    device's logits within bf16 rounding."""
    mesh_logits, one_logits = runs[1][0]["decode"]
    assert np.isfinite(one_logits).all()
    np.testing.assert_allclose(mesh_logits, one_logits, atol=5e-2, rtol=0)


def test_mesh_restart_is_bitwise(runs):
    assert all(bool(r["restart_bitwise"]) for r in runs[1])


def test_launcher_on_the_mesh(runs):
    ranks = runs[1]
    for r in ranks:
        assert tuple(r["launcher/mesh"]) == (4, 1)
        np.testing.assert_array_equal(r["launcher/loss"],
                                      ranks[0]["launcher/loss"])
        assert len(r["launcher/loss"]) == 2 and r["launcher/ckpt_bytes"] > 0
        assert "need 256 devices, have 4" in str(r["launcher/single"])
