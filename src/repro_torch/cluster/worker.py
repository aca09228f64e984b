"""The cluster worker: per-host LPA supersteps over the key-value store.

Each process owns the vertex ranges of the edge-shard hosts mapped to it
(``host % world == pid``, so a shrunk generation absorbs the dead
workers' shards) and loads ONLY those hosts' edge files
(:func:`bootstrap.load_edge_shard`).  One superstep per iteration:

1. score my vertices from my local edges against the current global
   labels: K2 (``kernels.spinner_scores``) over a CSR of my rows, the
   full label vector its lookup (on the CPU, its plain version) -- the
   reference's host ``np.add.at``, the same sums;
2. ``propose`` / ``finish`` from ``core.engine.make_update_parts`` --
   the Eq. 7-8 / 11-12 math every engine runs -- over my rows, with
   ``reduce_`` bound to :meth:`ClusterHandle.allreduce_sum` (M(l), the
   load delta and the halting scalars go through the store; at world
   size 1 it is the identity);
3. exchange label slices per owned host range through the store;
4. the Section 3.3 halting update, replicated on every process from the
   globally reduced score.

The random streams are the reference's: ``fold_in(PRNGKey(seed), t)``
over the FULL vertex set (noise from ``fold_in(., 0)``, ``u`` from
``fold_in(., 1)``, the initial labels from ``rng.randint``), of which a
process draws only its own rows (``rng.uniform(offset=)``: the same bits
as those rows of the full draw).  So the trajectory is a function of
(graph, job, initial labels), independent of the world size: a
generation that resumes from a snapshot with fewer processes walks the
iterations the dead one would have, which makes same-capacity recovery
bit-identical and lets any world size be held to a one-process run (and
to the reference's worker on the same shards and job).

Process 0 snapshots ``(labels, loads, best_score, stall, next_t)``
through ``repro_torch.ckpt`` every ``snapshot_every`` supersteps and
writes ``result.json`` + ``labels.npy`` at the end.  Heartbeats are file
mtimes under ``<workdir>/hb/``, touched every superstep and between the
sliced waits inside ``kv_get`` (``ClusterHandle.on_wait``).  Once
iteration ``t``'s first allreduce completes, every peer is past
iteration ``t-1``, and each process deletes the keys it wrote then.  A
fault is declared in ``job.json`` (``{"fault": {"gen": 0, "pid": 1,
"iteration": 6}}`` hard-exits that process at that superstep).

``job.json`` names the ``device``: the CUDA card by default (a run
without one raises), ``"cpu"`` for the tests.  Each process also keeps
``stats_g<gen>_p<pid>.json``, rewritten after every superstep: its
supersteps, K2 launches and the mean split of a superstep (draws, K2, propose/finish, store exchange -- the
label slices and the allreduces -- and heartbeat).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .. import rng
from ..ckpt import checkpoint
from ..core.engine import make_update_parts, resolve_device
from ..kernels.spinner_scores import spinner_scores
# import names, not the submodule: the package re-exports a function
# called ``bootstrap`` that shadows the module attribute
from . import snapshot as _snapshot
from .bootstrap import (ClusterConfig, PeerLost, bootstrap, load_edge_shard,
                        read_manifest)

_SPLIT = ("draws", "k2", "propose_finish", "exchange", "heartbeat")


def _beat(workdir: str, gen: int, pid: int) -> None:
    path = os.path.join(workdir, "hb", f"g{gen}_p{pid}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(str(time.time()))


def _host_range(h: int, v_per_host: int, V: int) -> tuple:
    return h * v_per_host, min((h + 1) * v_per_host, V)


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def owned_csr(shard_dir: str, owned: List[int], v_per_host: int, V: int):
    """The CSR of the rows of the hosts in ``owned`` (ascending), from
    their edge files alone: ``(rows, row_ptr, src, dst, w)`` -- the
    global ids of the rows in order, int64 offsets into the entries, and
    the entries (``dst`` global ids).  The files keep the graph's CSR
    order, so the concatenation is already sorted by row."""
    views = [load_edge_shard(shard_dir, h)[0] for h in owned]
    cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
    src = cat([v.src for v in views], np.int32)
    dst = cat([v.dst for v in views], np.int32)
    w = cat([v.weight for v in views], np.float32)
    rows = cat([np.arange(*_host_range(h, v_per_host, V), dtype=np.int64)
                for h in owned], np.int64)
    local = np.searchsorted(rows, src)          # my row of each entry
    row_ptr = np.zeros(rows.size + 1, np.int64)
    np.cumsum(np.bincount(local, minlength=rows.size), out=row_ptr[1:])
    return rows, row_ptr, src, dst, w


def run_worker(workdir: str, gen: int, world: int, pid: int,
               port: int) -> int:
    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    _beat(workdir, gen, pid)
    dev = resolve_device(job.get("device"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    handle = bootstrap(ClusterConfig(
        port=port, num_processes=world, process_id=pid,
        rpc_timeout=float(job.get("rpc_timeout", 60.0)),
        device=job.get("device")))
    # beat while blocked in store waits too: a superstep legitimately
    # blocks for up to rpc_timeout per read on a slow peer, which would
    # otherwise outlast the supervisor's heartbeat deadline
    handle.on_wait = lambda: _beat(workdir, gen, pid)

    shard_dir = job["shard_dir"]
    snap_dir = job.get("snapshot_dir", os.path.join(workdir, "snaps"))
    manifest = read_manifest(shard_dir)
    H, V = manifest["num_hosts"], manifest["num_vertices"]
    v_per_host = manifest["v_per_host"]
    owned = [h for h in range(H) if h % world == pid]
    rows, row_ptr, src, dst, w = owned_csr(shard_dir, owned, v_per_host, V)
    deg_w = np.load(os.path.join(shard_dir, "deg_w.npy"))
    ranges = [_host_range(h, v_per_host, V) for h in owned]

    k = int(job["k"])
    cfg = {"c": float(job.get("c", 1.05)),
           "eps": float(job.get("eps", 1e-3)),
           "halt_window": int(job.get("halt_window", 5)),
           "max_iters": int(job.get("max_iters", 120)),
           "seed": int(job.get("seed", 0)),
           "tie_noise": float(job.get("tie_noise", 1e-7)),
           "current_bonus": float(job.get("current_bonus", 1e-6)),
           "migration_weighting": job.get("migration_weighting", "edges")}
    snapshot_every = int(job.get("snapshot_every", 5))
    fault = job.get("fault")
    # a device scalar: dividing by a host scalar would multiply by its
    # reciprocal, which rounds otherwise than the reference's division
    C = torch.tensor(cfg["c"] * manifest["total_weight"] / k,
                     dtype=torch.float32, device=dev)

    propose, finish = make_update_parts(
        k, degree_weighted=cfg["migration_weighting"] == "edges",
        current_bonus=cfg["current_bonus"])
    key = rng.PRNGKey(cfg["seed"])
    key, k_init = rng.split(key)

    # resume from the newest complete snapshot, else the seeded init
    try:
        _, tree = _snapshot.newest_complete(snap_dir)
        labels = np.asarray(tree["labels"], np.int32)
        loads = np.asarray(tree["loads"], np.float32)
        best_score = float(tree["best_score"])
        stall = int(tree["stall"])
        t0 = int(tree["next_t"])
    except FileNotFoundError:
        labels = rng.randint(k_init, (V,), 0, k, device=dev).cpu().numpy()
        loads = np.zeros(k, np.float32)
        np.add.at(loads, labels, deg_w.astype(np.float32))
        best_score, stall, t0 = float("-inf"), 0, 0

    on_dev = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    rp_d, dst_d, w_d = on_dev(row_ptr), on_dev(dst), on_dev(w)
    deg_d = on_dev(deg_w[rows].astype(np.float32))
    rows_d = on_dev(rows)
    valid = torch.ones(rows.size, dtype=torch.bool, device=dev)
    lookup = on_dev(labels)
    k2_base = spinner_scores.launches
    split = dict.fromkeys(_SPLIT, 0.0)

    def write_stats(steps: int) -> None:
        """This process's counters so far (rewritten every superstep, so
        a killed generation leaves its last complete superstep's)."""
        path = os.path.join(workdir, f"stats_g{gen}_p{pid}.json")
        with open(path + ".tmp", "w") as f:
            json.dump({"gen": gen, "pid": pid, "world": world,
                       "device": str(dev), "rows": int(rows.size),
                       "entries": int(src.size), "supersteps": steps,
                       "k2_launches": spinner_scores.launches - k2_base,
                       "split_ms": {p: 1e3 * x / max(steps, 1)
                                    for p, x in split.items()}}, f)
        os.replace(path + ".tmp", path)
    halted = False
    t = t0
    for t in range(t0, cfg["max_iters"]):
        t_beat = time.perf_counter()
        _beat(workdir, gen, pid)
        if (fault and int(fault.get("gen", 0)) == gen
                and int(fault.get("pid", -1)) == pid
                and int(fault.get("iteration", -1)) == t):
            os._exit(int(fault.get("exit_code", 13)))
        tic = time.perf_counter()
        split["heartbeat"] += tic - t_beat
        it_key = rng.fold_in(key, t)
        k_noise, k_u = rng.fold_in(it_key, 0), rng.fold_in(it_key, 1)
        noise = torch.cat([rng.uniform(k_noise, (hi - lo, k), 0.0,
                                       cfg["tie_noise"], device=dev,
                                       offset=lo * k)
                           for lo, hi in ranges]) if ranges else \
            torch.zeros((0, k), dtype=torch.float32, device=dev)
        u = torch.cat([rng.uniform(k_u, (hi - lo,), device=dev, offset=lo)
                       for lo, hi in ranges]) if ranges else \
            torch.zeros(0, dtype=torch.float32, device=dev)
        lab_own = lookup[rows_d]
        t1 = _sync(dev)
        scores = spinner_scores(lab_own, rp_d, dst_d, w_d, k, lookup=lookup)
        t2 = _sync(dev)
        seq = [0]
        t_reduce = [0.0]

        def reduce_(parts):
            if world == 1:
                return parts
            out = []
            for x in parts:
                seq[0] += 1
                host = x.cpu().numpy()
                r0 = time.perf_counter()
                total = handle.allreduce_sum(f"g{gen}/t{t}/r{seq[0]}", host)
                t_reduce[0] += time.perf_counter() - r0
                out.append(torch.from_numpy(total).to(dev))
            return out

        loads_d = on_dev(loads)
        best, tot_best, tot_cur, m_partial = propose(
            scores, lab_own, deg_d, loads_d, noise, valid, C)
        new_own, new_loads, score_g, _n_mig, _mass = finish(
            best, tot_best, tot_cur, m_partial, lab_own, deg_d, loads_d,
            u, valid, C, reduce_)
        new_own = new_own.cpu().numpy()
        t3 = time.perf_counter()
        # iteration t's allreduce just completed, so every peer has
        # entered iteration t -- finished ALL of t-1's label reads -- and
        # the keys this process wrote at t-1 are dead
        if world > 1 and t > t0:
            handle.kv_delete(f"g{gen}/t{t - 1}/")
        merged = labels.copy()
        off = 0
        for h, (lo, hi) in zip(owned, ranges):
            merged[lo:hi] = new_own[off: off + hi - lo]
            off += hi - lo
            if world > 1:
                handle.kv_put_array(f"g{gen}/t{t}/lab/{h}", merged[lo:hi])
        if world > 1:
            for h in range(H):
                if h % world != pid:
                    lo, hi = _host_range(h, v_per_host, V)
                    merged[lo:hi] = handle.kv_get_array(
                        f"g{gen}/t{t}/lab/{h}", np.int32, (hi - lo,))
        labels = merged
        lookup = on_dev(labels)
        loads = new_loads.cpu().numpy().astype(np.float32)
        score = float(score_g)
        t4 = _sync(dev)

        # Section 3.3 halting, replicated on every process (the float
        # path of engine._halting_update: the first iteration's -inf + inf
        # comparison is False and counts toward the stall window)
        tol = cfg["eps"] * max(1.0, abs(best_score))
        improved = score > best_score + tol
        best_score = max(best_score, score)
        stall = 0 if improved else stall + 1
        halted = stall >= cfg["halt_window"]

        if pid == 0 and ((t + 1) % snapshot_every == 0 or halted):
            checkpoint.save(snap_dir, t + 1, {
                "labels": labels, "loads": loads,
                "best_score": np.float64(best_score),
                "stall": np.int64(stall),
                "next_t": np.int64(t + 1),
                "k": np.int64(k), "ndev": np.int64(world),
                "num_vertices": np.int64(V)})
            checkpoint.gc_old(snap_dir, keep=3)
        for part, dt in zip(_SPLIT[:4], (
                t1 - tic, t2 - t1, t3 - t2 - t_reduce[0],
                t4 - t3 + t_reduce[0])):
            split[part] += dt
        write_stats(t + 1 - t0)
        if halted:
            break

    # distributed phi: locally-internal edge weight over the total, one
    # final allreduce (each directed entry counted on its owner)
    part = np.asarray([float(w[labels[src] == labels[dst]].sum())
                       if src.size else 0.0,
                       float(w.sum())], np.float64)
    if world > 1:
        part = handle.allreduce_sum(f"g{gen}/final/phi", part)
        handle.kv_delete(f"g{gen}/t{t}/")   # everyone reached the phi reduce
    phi = part[0] / max(part[1], 1e-12)

    if pid == 0:
        np.save(os.path.join(workdir, "labels.npy"), labels)
        with open(os.path.join(workdir, "result.json"), "w") as f:
            json.dump({"iterations": t + 1, "halted": bool(halted),
                       "phi": float(phi), "gen": gen, "world": world,
                       "score": best_score}, f)
    if world > 1:
        handle.barrier(f"g{gen}/done")
    handle.shutdown()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--gen", type=int, default=0)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    a = ap.parse_args(argv)
    try:
        return run_worker(a.workdir, a.gen, a.world, a.pid, a.port)
    except PeerLost as e:
        print(f"peer lost: {e}", file=sys.stderr)
        return 3


if __name__ == "__main__":
    sys.exit(main())
