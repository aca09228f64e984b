"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and drives
the port's main path, single-device ``partition()``, on a
LiveJournal-scale graph (``watts_strogatz(4_000_000, 16, 0.3, seed=0)``,
about 128 M directed CSR entries, k = 32):

  (a) the card's name and power limit, and the kernel build time;
  (b) each kernel at the main path's full-size shapes against its plain
      PyTorch version on the same seeded inputs (uniform random labels)
      -- bitwise equal -- with CUDA-event median times of the kernel, the
      plain version and, for the score matrix, ``torch.sparse.mm`` as a
      library yardstick (which the port never calls);
  (c) the main path: ``partition(engine="fused")`` to its halt through
      the fused kernel (its launch count must equal the iterations); both
      kernels held and timed again as in (b) on the labels the run
      converged to (the times the kernels line reports); the split of one
      iteration into random draws, kernel and epilogue; and the
      score-matrix kernel's path (``fused_update="off"``) for a few
      iterations, which must give the same labels as the fused path;
  (d) a medium graph (``watts_strogatz(200_000, 16, 0.3, seed=1)``): the
      fused kernel, the split kernel and the PyTorch scatter oracle must
      give the same labels, loads and iteration counts; (d2) the same graph
      with its weights halved (0.5 and 1, so its degrees are not integers):
      ``partition`` through the fused kernel equal to the torch backend's
      run label for label, the fused kernel launched once per iteration,
      and both score kernels bitwise equal to their plain versions on the
      labels it converged to;
  (f) the Pregel applications on the full graph, placed by the labels (c)
      converged to and by the hash baseline: both placed layouts built on
      the card (timed); the two combine kernels at full size against
      their plain versions (min bitwise; sum within rtol 1e-5, atol 1e-9
      and bitwise equal to itself across launches), timed beside
      ``torch.sparse.mm`` / ``torch.segment_reduce`` yardsticks (which
      the port never calls), and the reduce timed on each placement;
      whole ``run_app`` runs -- PageRank 20 supersteps, WCC and BFS to
      the halt -- on both placements, each kernel launched once per
      superstep, WCC/BFS identical and PageRank within rtol 1e-4 across
      placements; one superstep split into its parts; and on the medium
      graph (with (d)'s labels) the kernels' runs against the plain
      versions' and against the numpy oracles;
  (g) the continuous-partitioning session on the full graph: (g1) the
      fused kernel's frontier variant at full size on (c)'s labels under
      two masks -- the dirty set of a 64,000-pair batch expanded one hop,
      and a seeded 10% -- bitwise equal to its plain version (inactive
      rows the no-op proposal), timed beside the base form with its byte
      bound at that active fraction, and one frontier iteration split into
      draws / kernel / expansion / epilogue; (g2) ``open_session(graph,
      SpinnerConfig(k=32))`` running ``partition()``, ``adapt(edge_updates=
      B1, frontier=True)`` (64,000 pairs, 0.1% of the edges) and
      ``adapt(edge_updates=B2)`` (640,000 pairs), once on the CUDA backend
      and once on the torch scatter oracle: identical results, two fast
      adapts, no host rebuild, the variant launched once per frontier
      iteration; (g3) on the medium graph, the fast path's dense adapt
      equal to the rebuilt graph's run;
  (h) the sharded engine: (h1) K1's seeded (overlap) form at a real
      frontier -- the full graph's 4-way layout built on the card, and on
      each shard the score kernel over the interior segment, then the
      seeded kernel over the frontier against (c)'s labels -- bitwise
      equal to its plain version and to the base kernel over the whole
      shard, each timed with its byte bound; (h2) ``partition(engine=
      "sharded")`` of the full graph on a one-rank NCCL mesh (one card),
      overlap on and off, identical to (c)'s fused run, no bytes
      exchanged, the seeded kernel launched once per iteration, the seeded
      kernel held and timed at that run's shapes, and one iteration split
      into draws / interior / exchange / seeded kernel / epilogue; (h3) on
      the medium graph, every exchange plan x overlap on/off x score
      backend identical to (d)'s run;
  (i) the Pregel applications on a mesh: (i1) the full graph's 4-way app
      layout built on the card for (c)'s labels and the hash labels; on
      each rank K3 over its interior, then K4 over its (non-empty)
      frontier seeded by K3's partial, reading the whole send vector, for
      PageRank's sum and WCC's min -- min bitwise, sum within rtol 1e-5
      and bitwise repeatable -- timed beside their bounds; each
      placement's halo counted on the card and the wire bytes a PageRank
      superstep would move under the halo plan, Spinner's below hash's;
      (i2) ``run_app(mesh=make_partition_mesh(1))`` of the full graph,
      PageRank/WCC/BFS with the allgather plan, overlap on and off,
      identical to (f)'s runs with nothing on the wire and K3/K4 launched
      once per superstep, and one superstep split into send / K3 /
      exchange / K4; (i3) on the medium graph every workload x plan x
      overlap x combine identical to the single-device run, and the
      4-way layout's halo counted on the card equal to
      ``HaloPlan.true_halo``;
  (j) continuous partitioning on a mesh (no kernel: the sharded frontier
      runner and the sharded delta merge run on the torch scatter
      backend): (j1) ``open_session`` of the full graph on a one-rank NCCL
      mesh (torch backend, overlap off, the allgather plan) running
      ``partition()``, ``adapt(edge_updates=B1, frontier=True)`` and
      ``adapt(edge_updates=B2)`` -- both adapts on the fast path with no
      host rebuild, uploads of 12 bytes an entry, each call's wall time,
      iterations, scored fraction and partitioning difference from the
      previous labels, all three identical to (g2)'s torch-backend run --
      and one sharded frontier iteration split into draws / exchange /
      expansion / scores / epilogue; (j2) on the medium graph from (d)'s
      labels, every exchange plan x fused on/off x noise mode of the mesh
      session (a frontier adapt then a dense one, ``max_iters`` 5)
      identical to the CPU run of its noise mode, the halo plans and an
      overflowing batch falling back, the CUDA backend's frontier adapt
      raising ``ValueError``; (j3) ``expert_placement_case()`` on the card
      identical to the CPU run;
  (k) the serving tier (``repro_torch.serve``): (k1) eight same-bucket
      tenants (``traffic.tenant_graph(200_000 + 17 i, seed=i, k_nbrs=16)``,
      k = 32), one warm and three timed rounds in which every tenant
      receives three 4,000-pair edge-update requests: naive serving (one
      adapt per request), the scheduler serial and batched on the torch
      backend, and the scheduler on the CUDA backend (serial, K1 once an
      iteration); every ticket identical to a twin session (one adapt per
      coalesced window, or per request for naive), one batched run a
      round, no upload or host rebuild after the warm round; throughput,
      coalescing, batched/serial ratio, occupancy, and one batched
      iteration split beside the eight serial ones; (k2) an open-loop
      Poisson replay over 16 power-law CUDA-backend tenants with the
      default policies, drained with no error (latency p50/p99,
      throughput, coalescing); (k3) export_state, checkpoint save and
      restore, import_state into a fresh session: its next adapt
      identical to the uninterrupted session's;
  (e) each kernel's achieved bytes/s (the bytes its bound counts over its
      measured time) beside its bound, then one JSON line describing each
      kernel.

Exits non-zero, printing no result, if there is no CUDA device or any
check fails.  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores
FULL_N, MEDIUM_N, DEG, BETA, K = 4_000_000, 200_000, 16, 0.3, 32
SPLIT_ITERS = 8                    # depth of the score-matrix path run
PAGERANK_ITERS = 20
B1_PAIRS, B2_PAIRS = 64_000, 640_000   # 0.1% and 1% of the full graph's edges
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/spinner_scores.cu"
PREGEL_SOURCE = "src/repro_torch/kernels/csrc/pregel_combine.cu"
PREGEL_TPU = "src/repro/kernels/pregel_combine.py"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_err(pairs) -> float:
    return max(float((a.double() - b.double()).abs().max()) if a.numel()
               else 0.0 for a, b in pairs)


def kernels_against_plain(padded, dev, labels, pen, noise,
                          num_real: int) -> dict:
    """Both kernels on these inputs against their plain versions: bitwise
    equal, with CUDA-event median times of the kernel, the plain version
    and, for the score matrix, ``torch.sparse.mm`` (a library yardstick
    the port never calls)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.spinner_scores import fused_update, spinner_scores

    csr = padded.to_device(dev)
    v = padded.num_vertices
    src = csr.src

    def k2():
        return spinner_scores(labels, csr.row_ptr, csr.dst, csr.weight, K)

    def k2_plain():
        return ref.spinner_scores_ref(labels, src, csr.dst, csr.weight, v, K)

    def k1(weighted=True):
        return fused_update(labels, csr.row_ptr, csr.dst, csr.weight,
                            csr.deg_w, pen, noise, num_real, K, 1e-6,
                            weighted)

    def k1_plain(weighted=True):
        return ref.fused_propose_ref(labels, src, csr.dst, csr.weight,
                                     csr.deg_w, pen, noise, num_real, K,
                                     1e-6, weighted)

    out, want = k2(), k2_plain()
    torch.cuda.synchronize()
    check(bits_equal(out, want), "spinner_scores_csr != scatter-add")
    k2_err = max_abs_err([(out, want)])
    del out, want
    k1_err = 0.0
    for weighted in (True, False):
        got, exp = k1(weighted), k1_plain(weighted)
        torch.cuda.synchronize()
        # float32 integer sums are exact (and so order-free) below 2^24
        check(float(exp[3].max()) < 2**24, "M(l) reached 2^24")
        for name, a, b in zip(("best", "tot_best", "tot_cur", "m"), got, exp):
            check(bits_equal(a, b),
                  f"fused_update_csr {name} != fused_propose_ref "
                  f"(degree_weighted={weighted})")
        k1_err = max(k1_err, max_abs_err(zip(got, exp)))
        del got, exp

    # library yardstick for the score matrix: CSR sparse x dense one-hot
    a_csr = torch.sparse_csr_tensor(csr.row_ptr.to(torch.int32), csr.dst,
                                    csr.weight, size=(v, v),
                                    check_invariants=False)
    onehot = torch.nn.functional.one_hot(labels.long(), K).to(torch.float32)
    lib_out = torch.sparse.mm(a_csr, onehot)
    torch.cuda.synchronize()
    lib_equal = bits_equal(lib_out, k2_plain())
    del lib_out

    times = dict(
        k2=time_ms(k2, reps=20), k2_plain=time_ms(k2_plain, reps=5),
        lib=time_ms(lambda: torch.sparse.mm(a_csr, onehot), reps=20),
        k1=time_ms(k1, reps=20), k1_plain=time_ms(k1_plain, reps=5))
    del a_csr, onehot
    return {
        "spinner_scores_csr": dict(
            max_abs_err=k2_err, ms=times["k2"], plain_ms=times["k2_plain"],
            library_ms=times["lib"], library_bitwise_equal=lib_equal),
        "fused_update_csr": dict(
            max_abs_err=k1_err, ms=times["k1"], plain_ms=times["k1_plain"],
            library_ms=None),
    }


def print_kernels(tag: str, res: dict) -> None:
    for name, r in res.items():
        print(f"({tag}) {name}: bitwise equal (max_abs_err "
              f"{r['max_abs_err']}), {r['ms']:.3f} ms (plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']})",
              flush=True)


def phase_kernels(padded, dev, report: dict) -> None:
    """(b) Both kernels at full size on uniform random labels."""
    from repro_torch import rng

    csr = padded.to_device(dev)
    v, e = padded.num_vertices, padded.num_directed_entries
    gen = np.random.default_rng(11)
    labels = torch.from_numpy(gen.integers(0, K, v, dtype=np.int32)).to(dev)
    # the penalty a run sees: loads of these labels over the capacity
    loads = torch.zeros(K, dtype=torch.float32, device=dev).index_add_(
        0, labels.long(), csr.deg_w)
    pen = loads / torch.tensor(1.05 * padded.total_weight / K,
                               dtype=torch.float32, device=dev)
    noise = rng.uniform(rng.PRNGKey(12), (v, K), 0.0, 1e-7, device=dev)
    res = kernels_against_plain(padded, dev, labels, pen, noise, v - 1000)
    print_kernels("b, random labels", res)

    # bytes each call must move: every input read once, every output
    # written once (row_ptr int64, dst int32, w f32, labels int32, ...)
    csr_bytes = (v + 1) * 8 + e * 4 + e * 4 + v * 4
    k2_bytes = csr_bytes + v * K * 4
    k1_bytes = csr_bytes + v * 4 + K * 4 + v * K * 4 + 3 * v * 4 + K * 4
    for name, nbytes in (("spinner_scores_csr", k2_bytes),
                         ("fused_update_csr", k1_bytes)):
        report[name] = dict(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                            bytes=nbytes, random_labels=res[name])
        print(f"(b) {name}: bound {report[name]['bound_ms']:.3f} ms for "
              f"{nbytes} B", flush=True)
    print(f"(b) shapes: V_pad={v} E_pad={e} k={K}; torch.sparse.mm "
          f"bitwise equal to the scatter-add: "
          f"{res['spinner_scores_csr']['library_bitwise_equal']}", flush=True)


def phase_main_path(graph, padded, dev, report: dict) -> np.ndarray:
    """(c) The main path at full size, through the fused kernel; returns
    the labels it converged to."""
    from repro_torch import rng
    from repro_torch.core import EngineOptions, SpinnerConfig, metrics
    from repro_torch.core import engine, partition
    from repro_torch.kernels.spinner_scores import fused_update, spinner_scores

    cfg = SpinnerConfig(k=K)
    opts = EngineOptions(device=dev)
    fused_update.launches = spinner_scores.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = partition(graph, cfg, engine="fused", options=opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_launches, k2_launches = fused_update.launches, spinner_scores.launches
    check(k1_launches == res.iterations,
          f"fused_update_csr launched {k1_launches} times in "
          f"{res.iterations} iterations")
    check(k2_launches == 0, "split score kernel ran on the fused path")
    report["fused_update_csr"]["launches"] = k1_launches

    check(res.labels.shape == (graph.num_vertices,), "label shape")
    check(int(res.labels.min()) >= 0 and int(res.labels.max()) < K,
          "labels outside [0, k)")
    check(np.array_equal(res.loads.astype(np.float64),
                         metrics.loads(graph, res.labels, K)),
          "loads disagree with the labels' degree sums")
    phi, rho = metrics.phi(graph, res.labels), metrics.rho(graph,
                                                           res.labels, K)
    check(np.isfinite(phi) and phi > 2.0 / K, f"phi {phi} not above random")
    check(rho <= cfg.c + 0.05, f"rho {rho} above capacity")
    print(f"(c) partition(engine='fused') V={graph.num_vertices} "
          f"E={graph.num_directed_entries} k={K}: iterations="
          f"{res.iterations} halted={res.halted} phi={phi:.6f} "
          f"rho={rho:.6f} wall={wall:.3f}s "
          f"ms/iteration={wall / res.iterations * 1e3:.3f} "
          f"fused_update_csr launches={k1_launches}", flush=True)
    report["main_result"] = dict(labels=res.labels, loads=res.loads,
                                 iterations=res.iterations,
                                 halted=res.halted)
    report["main_path"] = dict(iterations=res.iterations,
                               halted=res.halted, phi=phi, rho=rho,
                               wall_s=wall,
                               ms_per_iteration=wall / res.iterations * 1e3)

    # the kernels on the labels the main path converged to: these are the
    # times the kernels line reports, since most iterations see such labels
    bind, _ = engine.make_bind(graph, cfg, opts, dev)
    v_pad = padded.num_vertices
    labels = engine.pad_labels(torch.from_numpy(res.labels).to(dev), v_pad)
    loads = torch.from_numpy(res.loads).to(dev)
    pen = loads / bind.capacity
    k_noise, k_mig = rng.split(rng.split(rng.PRNGKey(5))[1])
    noise = rng.uniform(k_noise, (v_pad, K), 0.0, cfg.tie_noise, device=dev)
    u = rng.uniform(k_mig, (v_pad,), device=dev)
    converged = kernels_against_plain(padded, dev, labels, pen, noise,
                                      bind.num_real)
    print_kernels("c, converged labels", converged)
    for name, r in converged.items():
        rand = report[name]["random_labels"]
        r["max_abs_err"] = max(r["max_abs_err"], rand["max_abs_err"])
        report[name].update(r)

    # one iteration split into its parts, on the final labels
    _, finish = engine.make_update_parts(K, degree_weighted=True,
                                         current_bonus=cfg.current_bonus)
    parts = fused_update(labels, *bind.score, bind.deg_w, pen, noise,
                         bind.num_real, K, cfg.current_bonus, True)
    split = {
        "rng_ms": time_ms(lambda: (
            rng.uniform(k_noise, (v_pad, K), 0.0, cfg.tie_noise, device=dev),
            rng.uniform(k_mig, (v_pad,), device=dev)), reps=5),
        "kernel_ms": converged["fused_update_csr"]["ms"],
        "epilogue_ms": time_ms(lambda: finish(
            *parts, labels, bind.deg_w, loads, u, bind.valid, bind.capacity),
            reps=10),
    }
    report["main_path"].update(split)
    print("(c) one iteration: " + " ".join(f"{k}={v:.3f}"
                                          for k, v in split.items()),
          flush=True)

    # the score-matrix kernel's path, cut to SPLIT_ITERS iterations
    short = SpinnerConfig(k=K, max_iters=SPLIT_ITERS)
    spinner_scores.launches = fused_update.launches = 0
    off = partition(graph, short, engine="fused",
                    options=EngineOptions(device=dev, fused_update="off"))
    k2_launches = spinner_scores.launches
    check(k2_launches == off.iterations >= 1,
          f"spinner_scores_csr launched {k2_launches} times in "
          f"{off.iterations} iterations")
    check(fused_update.launches == 0, "fused kernel ran on the split path")
    report["spinner_scores_csr"]["launches"] = k2_launches
    on = partition(graph, short, engine="fused", options=opts)
    check(np.array_equal(on.labels, off.labels)
          and np.array_equal(on.loads, off.loads),
          "fused and split kernel paths diverged at full size")
    print(f"(c) fused_update='off' path, {SPLIT_ITERS} iterations: "
          f"spinner_scores_csr launches={k2_launches}; labels and loads "
          f"equal to the fused path's", flush=True)
    return res.labels


def phase_medium_parity(dev, report: dict) -> tuple:
    """(d) Backends and fused/split paths agree label for label; returns
    the medium graph and its labels."""
    from repro_torch.core import EngineOptions, SpinnerConfig, generators
    from repro_torch.core import partition

    g = generators.watts_strogatz(MEDIUM_N, DEG, BETA, seed=1)
    cfg = SpinnerConfig(k=K)
    runs = {}
    for backend, fused in (("cuda", "on"), ("cuda", "off"), ("torch", "off")):
        t0 = time.perf_counter()
        runs[backend, fused] = partition(
            g, cfg, engine="fused",
            options=EngineOptions(device=dev, score_backend=backend,
                                  fused_update=fused))
        torch.cuda.synchronize()
        print(f"(d) {backend}/{fused}: iterations="
              f"{runs[backend, fused].iterations} "
              f"wall={time.perf_counter() - t0:.3f}s", flush=True)
    base = runs["torch", "off"]
    for key, res in runs.items():
        check(np.array_equal(res.labels, base.labels)
              and np.array_equal(res.loads, base.loads)
              and res.iterations == base.iterations
              and res.halted == base.halted,
              f"{key} disagrees with the torch scatter oracle")
    report["medium"] = dict(iterations=base.iterations, halted=base.halted)
    report["medium_result"] = dict(loads=base.loads,
                                   iterations=base.iterations,
                                   halted=base.halted)
    print(f"(d) medium parity V={MEDIUM_N}: cuda/on, cuda/off and torch/off "
          f"identical ({base.iterations} iterations)", flush=True)
    return g, base.labels


def phase_halved_weights(g, dev) -> None:
    """(d2) The medium graph with its weights halved: the fused kernel's
    run against the torch backend's, and both score kernels against their
    plain versions on the labels it converged to."""
    from repro_torch import rng
    from repro_torch.core import EngineOptions, SpinnerConfig, engine
    from repro_torch.core import partition
    from repro_torch.core.graph import _finish
    from repro_torch.kernels import ref
    from repro_torch.kernels.spinner_scores import fused_update, spinner_scores

    half = _finish(g.src, g.dst, np.float32(0.5) * g.weight, g.num_vertices)
    check(not np.array_equal(half.deg_w, np.round(half.deg_w)),
          "halved degrees are all integers")
    cfg = SpinnerConfig(k=K)
    runs = {}
    for backend, fused in (("cuda", "on"), ("torch", "off")):
        fused_update.launches = spinner_scores.launches = 0
        runs[backend] = partition(half, cfg, engine="fused", options=(
            EngineOptions(device=dev, score_backend=backend,
                          fused_update=fused)))
        n1, n2 = fused_update.launches, spinner_scores.launches
        check((n1, n2) == ((runs[backend].iterations, 0) if backend == "cuda"
                           else (0, 0)),
              f"halved weights, {backend}: launches {n1}/{n2} in "
              f"{runs[backend].iterations} iterations")
    a, b = runs["cuda"], runs["torch"]
    check(np.array_equal(a.labels, b.labels)
          and np.array_equal(a.loads, b.loads)
          and (a.iterations, a.halted) == (b.iterations, b.halted),
          "halved weights: the fused kernel's run differs from torch's")
    padded, num_real = engine.padded_view(half, EngineOptions(device=dev))
    csr = padded.to_device(dev)
    v = padded.num_vertices
    labels = engine.pad_labels(torch.from_numpy(a.labels).to(dev), v)
    pen = torch.from_numpy(a.loads).to(dev) / torch.tensor(
        cfg.c * padded.total_weight / K, dtype=torch.float32, device=dev)
    noise = rng.uniform(rng.PRNGKey(17), (v, K), 0.0, cfg.tie_noise,
                        device=dev)
    got = (spinner_scores(labels, csr.row_ptr, csr.dst, csr.weight, K),
           *fused_update(labels, csr.row_ptr, csr.dst, csr.weight, csr.deg_w,
                         pen, noise, num_real, K, cfg.current_bonus, True))
    want = (ref.spinner_scores_ref(labels, csr.src, csr.dst, csr.weight, v,
                                   K),
            *ref.fused_propose_ref(labels, csr.src, csr.dst, csr.weight,
                                   csr.deg_w, pen, noise, num_real, K,
                                   cfg.current_bonus, True))
    torch.cuda.synchronize()
    for name, x, y in zip(("scores", "best", "tot_best", "tot_cur", "m"),
                          got, want):
        check(bits_equal(x, y), f"halved weights: {name} != plain")
    print(f"(d2) medium V={g.num_vertices}, weights halved: cuda/on and "
          f"torch/off identical ({a.iterations} iterations, halted="
          f"{a.halted}, fused_update_csr launches={a.iterations}); "
          f"spinner_scores_csr and fused_update_csr bitwise equal to their "
          f"plain versions on its labels", flush=True)


def hash_labels(v: int, k: int) -> np.ndarray:
    """The hash placement baseline (vertex id times Knuth's constant)."""
    return (np.arange(v, dtype=np.int64) * 2654435761 % k).astype(np.int32)


def pregel_bound(rp, dst, combine: str, seeded: bool, update: bool,
                 lookup_read: int = None) -> dict:
    """The least time of one combine-kernel call on this CSR: the bytes
    it must move (row_ptr 8 B/row, dst 4 B/edge, the send vector once --
    or its ``lookup_read`` entries the edges reference, where the lookup
    is not the rows' own vector; not read at all when there are no
    edges --, the seed, and for the
    update the valid mask and the min's values in, the (rows,) outputs
    out) over the memory rate, against its operations (an add or a min
    per edge) over the float32 rate.  ``bytes_with_gather`` counts the
    send gather at 4 B per edge instead, as if no gathered value hit L2."""
    rows, edges = rp.numel() - 1, dst.numel()
    fixed = (rows + 1) * 8 + edges * 4 + rows * 4
    if seeded:
        fixed += rows * 4
    if update:
        fixed += rows + rows + (rows * 4 if combine == "min" else 0)
    nbytes = fixed + ((rows if lookup_read is None else lookup_read) * 4
                      if edges else 0)
    ops = edges * (1 if combine == "sum" else 2) + rows * (2 if update else 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, ops=ops,
                bound_ms_with_gather=(fixed + edges * 4) / HBM_BYTES_PER_S
                * 1e3)


def pregel_kernels_against_plain(lay, dev, report: dict) -> None:
    """(f) Both combine kernels on the placed full-size layout against
    their plain versions, then timed (CUDA-event medians) with their
    plain versions and library yardsticks the port never calls."""
    from repro_torch.apps import APPS, init_values
    from repro_torch.kernels import ref
    from repro_torch.kernels.pregel_combine import (pregel_combine,
                                                    pregel_reduce)

    v, n, e = lay.v_pad, lay.num_real, lay.dst.numel()

    def up(a):
        return torch.from_numpy(a).to(dev)

    pr0 = up(init_values(APPS["pagerank"], lay))
    wcc0 = up(init_values(APPS["wcc"], lay))
    bfs0 = up(init_values(APPS["bfs"], lay, source=0))
    gen = np.random.default_rng(13)
    seeds = {"sum": up(gen.uniform(0.0, 1.0 / n, v).astype(np.float32)),
             "min": up(gen.integers(0, n, v).astype(np.int32))}
    base = float(np.float32(0.15 / n))
    # (combine, update, bias, send, values): PageRank's first message
    # vector, WCC's initial ids, BFS's initial distances (+1 per hop)
    cases = [("sum", "pagerank", 0, pr0 / torch.clamp(lay.deg_cnt, min=1.0),
              pr0), ("min", "min", 0, wcc0, wcc0), ("min", "min", 1, bfs0,
                                                     bfs0)]
    full = (lay.row_ptr, lay.dst)
    front = (lay.frontier_row_ptr, lay.frontier_dst)
    errs = {"pregel_reduce_csr": 0.0, "pregel_combine_csr": 0.0}

    def hold(name, combine, got, again, want):
        torch.cuda.synchronize()
        for a, b, c in zip(got, again, want):
            check(bits_equal(a, b), f"{name} ({combine}) differs between "
                  f"two launches")
            if combine == "min" or a.dtype == torch.bool:
                check(bits_equal(a, c), f"{name} ({combine}) != plain")
            else:
                check(bool(torch.allclose(a, c, rtol=1e-5, atol=1e-9)),
                      f"{name} ({combine}) outside rtol 1e-5 of plain")
        errs[name] = max(errs[name], max_abs_err(zip(got, want)))

    for combine, update, bias, send, values in cases:
        for rp, dst, seed in ((*full, None), (*full, seeds[combine]),
                              (*front, seeds[combine])):
            kw = dict(combine=combine, bias=bias, acc_init=seed)
            hold("pregel_reduce_csr", combine,
                 (pregel_reduce(send, rp, dst, **kw),),
                 (pregel_reduce(send, rp, dst, **kw),),
                 (ref.pregel_reduce_ref(send, rp, dst, **kw),))
            ckw = dict(kw, update=update, damping=0.85)
            hold("pregel_combine_csr", combine,
                 pregel_combine(send, rp, dst, values, lay.valid, base,
                                **ckw),
                 pregel_combine(send, rp, dst, values, lay.valid, base,
                                **ckw),
                 ref.pregel_combine_ref(send, rp, dst, values, lay.valid,
                                        base, **ckw))
    print(f"(f) pregel_reduce_csr / pregel_combine_csr at V_pad={v} E={e}: "
          f"min bitwise equal, sum within rtol 1e-5 (max_abs_err "
          f"{errs['pregel_reduce_csr']} / {errs['pregel_combine_csr']}), "
          f"each bitwise equal across two launches, over the full CSR and "
          f"the empty frontier, with and without acc_init", flush=True)

    a_csr = torch.sparse_csr_tensor(lay.row_ptr.to(torch.int32), lay.dst,
                                    torch.ones(e, device=dev), size=(v, v),
                                    check_invariants=False)
    out = {"pregel_reduce_csr": dict(max_abs_err=errs["pregel_reduce_csr"]),
           "pregel_combine_csr": dict(
               max_abs_err=errs["pregel_combine_csr"], library_ms=None)}
    for combine, update, bias, send, values in cases[:2]:
        kw = dict(combine=combine, bias=bias)
        partial = pregel_reduce(send, *full, **kw)
        ckw = dict(kw, update=update, damping=0.85, acc_init=partial)
        if combine == "sum":
            def library():
                return torch.sparse.mm(a_csr, send[:, None])
        else:
            def library():     # segment_reduce takes no int32: cast
                return torch.segment_reduce(
                    (send[lay.dst] + bias).to(torch.float32), "min",
                    offsets=lay.row_ptr, initial=float(ref.INF_I32))
        lib_err = max_abs_err([(library().reshape(-1).double(),
                                partial.double())])
        sfx = "" if combine == "sum" else "_min"
        k3, k4 = out["pregel_reduce_csr"], out["pregel_combine_csr"]
        k3.update({
            "ms" + sfx: time_ms(lambda: pregel_reduce(send, *full, **kw),
                                reps=20),
            "plain_ms" + sfx: time_ms(lambda: ref.pregel_reduce_ref(
                send, *full, **kw), reps=5),
            "library_ms" + sfx: time_ms(library, reps=20),
            "library_max_abs_err" + sfx: lib_err})
        k3.update({k + sfx: x for k, x in pregel_bound(
            *full, combine, False, False).items()})
        # the main path's call: the empty frontier, seeded by the partial
        k4.update({
            "ms" + sfx: time_ms(lambda: pregel_combine(
                send, *front, values, lay.valid, base, **ckw), reps=20),
            "plain_ms" + sfx: time_ms(lambda: ref.pregel_combine_ref(
                send, *front, values, lay.valid, base, **ckw), reps=5),
            "ms_full_csr" + sfx: time_ms(lambda: pregel_combine(
                send, *full, values, lay.valid, base, **ckw), reps=20),
            "plain_ms_full_csr" + sfx: time_ms(lambda: ref.pregel_combine_ref(
                send, *full, values, lay.valid, base, **ckw), reps=5),
            "library_reduce_ms_full_csr" + sfx: k3["library_ms" + sfx]})
        k4.update({k + sfx: x for k, x in pregel_bound(
            *front, combine, True, True).items()})
        k4["bound_ms_full_csr" + sfx] = pregel_bound(
            *full, combine, True, True)["bound_ms"]
        for name, r in (("pregel_reduce_csr", k3),
                        ("pregel_combine_csr", k4)):
            print(f"(f) {name} ({combine}): {r['ms' + sfx]:.3f} ms, plain "
                  f"{r['plain_ms' + sfx]:.3f} ms, bound "
                  f"{r['bound_ms' + sfx]:.3f} ms for {r['bytes' + sfx]} B"
                  + (f", library {r['library_ms' + sfx]:.3f} ms (max_abs_err "
                     f"{lib_err} against the kernel)" if name.startswith(
                         "pregel_reduce") else
                     f"; over the full CSR {r['ms_full_csr' + sfx]:.3f} ms "
                     f"(plain {r['plain_ms_full_csr' + sfx]:.3f}, bound "
                     f"{r['bound_ms_full_csr' + sfx]:.3f})"), flush=True)
    del a_csr
    k3 = out["pregel_reduce_csr"]
    print(f"(f) pregel_reduce_csr (sum) against torch.sparse.mm in this run: "
          f"{k3['ms']:.3f} ms / {k3['library_ms']:.3f} ms = "
          f"{k3['ms'] / k3['library_ms']:.3f}", flush=True)
    report.update(out)


def reduce_ms_by_placement(layouts: dict, dev) -> dict:
    """(f) ``pregel_reduce_csr``'s time on each placed layout (PageRank's
    first messages and WCC's ids), CUDA-event medians taken in turns
    (spinner, hash, hash, spinner) and averaged per placement."""
    from repro_torch.apps import APPS, init_values
    from repro_torch.kernels.pregel_combine import pregel_reduce

    times = {name: {"sum": [], "min": []} for name in layouts}
    names = list(layouts)
    for name in names + names[::-1]:
        lay = layouts[name]
        for wl, combine in (("pagerank", "sum"), ("wcc", "min")):
            send = torch.from_numpy(init_values(APPS[wl], lay)).to(dev)
            if combine == "sum":
                send = send / torch.clamp(lay.deg_cnt, min=1.0)
            times[name][combine].append(time_ms(
                lambda: pregel_reduce(send, lay.row_ptr, lay.dst,
                                      combine=combine), reps=20))
    out = {name: {c: statistics.mean(ts) for c, ts in t.items()}
           for name, t in times.items()}
    print("(f) pregel_reduce_csr by placement: " + "; ".join(
        f"{name} sum {t['sum']:.3f} ms, min {t['min']:.3f} ms"
        for name, t in out.items()), flush=True)
    return out


def phase_apps(graph, labels: np.ndarray, dev, report: dict) -> None:
    """(f) The Pregel applications at full size on both placements."""
    from repro_torch.apps import build_app_layout, run_app
    from repro_torch.kernels.pregel_combine import (pregel_combine,
                                                    pregel_reduce)

    placements = {"spinner": labels,
                  "hash": hash_labels(graph.num_vertices, K)}
    for name, lab in placements.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lay = build_app_layout(graph, lab, dev)
        torch.cuda.synchronize()
        print(f"(f) {name} layout built on the card in "
              f"{time.perf_counter() - t0:.3f}s: V_pad={lay.v_pad} "
              f"E={lay.dst.numel()}", flush=True)
    pregel_kernels_against_plain(build_app_layout(graph, labels, dev), dev,
                                 report)
    torch.cuda.empty_cache()
    report["pregel_reduce_csr"]["ms_by_placement"] = reduce_ms_by_placement(
        {name: build_app_layout(graph, lab, dev)
         for name, lab in placements.items()}, dev)

    runs, launches = {}, 0
    src, dst = graph.src, graph.dst
    for i, (wl, kw) in enumerate((("pagerank", dict(iters=PAGERANK_ITERS)),
                                  ("wcc", {}), ("bfs", dict(source=0)))):
        order = list(placements.items())
        for name, lab in (order if i % 2 == 0 else order[::-1]):
            pregel_reduce.launches = pregel_combine.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = run_app(graph, lab, wl, device=dev, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n3, n4 = pregel_reduce.launches, pregel_combine.launches
            check(n3 == n4 == r.supersteps >= 1,
                  f"{wl}/{name}: kernels launched {n3}/{n4} times in "
                  f"{r.supersteps} supersteps")
            check(r.converged and r.values.shape == (graph.num_vertices,),
                  f"{wl}/{name}: not converged or wrong shape")
            launches += n3
            runs[wl, name] = (r, wall)
            print(f"(f) {wl} on the {name} placement: supersteps="
                  f"{r.supersteps} wall={wall:.3f}s ms/superstep="
                  f"{wall / r.supersteps * 1e3:.3f} messages="
                  f"{r.device_messages[0]:.0f} launches={n3}+{n4}",
                  flush=True)
        (a, wa), (b, wb) = runs[wl, "spinner"], runs[wl, "hash"]
        check(a.supersteps == b.supersteps, f"{wl}: supersteps differ "
              f"between placements")
        check(bool(np.allclose(a.device_messages, b.device_messages,
                               rtol=1e-6, atol=0)),
              f"{wl}: message counts differ between placements")
        if wl == "pagerank":
            check(bool(np.allclose(a.values, b.values, rtol=1e-4,
                                   atol=1e-9)),
                  "pagerank differs between placements")
            total = float(a.values.astype(np.float64).sum())
            check(abs(total - 1.0) < 1e-3, f"pagerank sums to {total}")
        else:
            check(np.array_equal(a.values, b.values),
                  f"{wl} differs between placements")
        if wl == "wcc":      # a fixed point: every edge inside a component
            comp = a.values
            check(np.array_equal(comp[src], comp[dst])
                  and bool((comp <= np.arange(comp.size)).all()),
                  "wcc is not a fixed point")
        if wl == "bfs":      # distances: source 0, neighbours within a hop
            d = a.values
            check(d[0] == 0 and bool(np.isfinite(d).all())
                  and bool((np.abs(d[src] - d[dst]) <= 1).all()),
                  "bfs distances violate an edge")
        print(f"(f) {wl}: identical under both placements"
              f"{' (within rtol 1e-4)' if wl == 'pagerank' else ''}; "
              f"spinner/hash wall ratio {wa / wb:.3f} (information only)",
              flush=True)
    report["pregel_reduce_csr"]["launches"] = launches
    report["pregel_combine_csr"]["launches"] = launches
    report["app_results"] = {wl: r for (wl, name), (r, _) in runs.items()
                             if name == "spinner"}
    superstep_split(build_app_layout(graph, labels, dev), dev, report)
    report["apps"] = {f"{wl}/{name}": dict(
        supersteps=r.supersteps, wall_s=wall,
        ms_per_superstep=wall / r.supersteps * 1e3)
        for (wl, name), (r, wall) in runs.items()}


def superstep_split(lay, dev, report: dict) -> None:
    """(f) One PageRank and one WCC superstep on the Spinner layout, end
    to end and split into the parts outside the kernels (CUDA-event
    medians; the kernels' own times are the kernels line's)."""
    from repro_torch.apps import APPS, AppState, init_active, init_values
    from repro_torch.apps.engine import COMBINE_BACKENDS, make_superstep

    share = torch.clamp(lay.deg_cnt, min=1.0)
    split = {}
    for wl in ("pagerank", "wcc"):
        spec = APPS[wl]
        step = make_superstep(spec, lay.shard(0), *COMBINE_BACKENDS["cuda"],
                              0.85, lay.num_real)
        values = torch.from_numpy(init_values(spec, lay)).to(dev)
        changed = torch.from_numpy(init_active(spec, lay)).to(dev)
        state = AppState(values=values, changed=changed, step=0,
                         active=int(changed.sum()),
                         msgs=torch.zeros((), device=dev))
        parts = {"superstep_ms": time_ms(lambda: step(state, None),
                                         reps=20),
                 "msgs_ms": time_ms(lambda: state.msgs + (
                     lay.deg_cnt * changed.to(torch.float32)).sum(),
                     reps=20)}
        if wl == "pagerank":
            parts["send_ms"] = time_ms(lambda: values / share, reps=20)
        else:
            parts["active_read_ms"] = time_ms(lambda: int(changed.sum()),
                                              reps=20)
        split[wl] = parts
        print(f"(f) one {wl} superstep (spinner layout): " + " ".join(
            f"{k}={x:.3f}" for k, x in parts.items()), flush=True)
    report["superstep_split"] = split


def phase_apps_medium(g, labels: np.ndarray, dev) -> None:
    """(f) On the medium graph: the kernels' runs against the plain
    versions' (``combine="torch"``) and the numpy oracles."""
    from repro_torch.apps import run_app
    from repro_torch.core import pregel

    oracles = {"pagerank": pregel.pagerank(g, labels, K,
                                           iters=PAGERANK_ITERS),
               "wcc": pregel.wcc(g, labels, K),
               "bfs": pregel.sssp(g, 0, labels, K)}
    oracles["sssp"] = oracles["bfs"]
    for wl, oracle in oracles.items():
        a = run_app(g, labels, wl, device=dev)
        b = run_app(g, labels, wl, combine="torch", device=dev)
        check(a.supersteps == b.supersteps == oracle.supersteps
              and a.converged and b.converged,
              f"medium {wl}: supersteps {a.supersteps}/{b.supersteps}/"
              f"{oracle.supersteps}")
        check(bool(np.allclose(a.device_messages, b.device_messages,
                               rtol=1e-6, atol=0)),
              f"medium {wl}: message counts differ between backends")
        if wl == "pagerank":
            for got in (a, b):
                check(bool(np.allclose(got.values, oracle.values,
                                       rtol=1e-4, atol=1e-9)),
                      "medium pagerank outside rtol 1e-4 of the oracle")
        else:
            check(np.array_equal(a.values, b.values)
                  and np.array_equal(a.values, oracle.values),
                  f"medium {wl} differs from the plain run or the oracle")
        print(f"(f) medium {wl} V={g.num_vertices}: cuda and torch combine "
              f"agree with each other and the numpy oracle "
              f"({a.supersteps} supersteps)", flush=True)


def edge_batch(v: int, n: int, seed: int) -> tuple:
    """``n`` random (src, dst) pairs over ``v`` vertices, from ``seed``."""
    gen = np.random.default_rng(seed)
    return gen.integers(0, v, n), gen.integers(0, v, n)


def frontier_bound(csr, active: torch.Tensor, k: int) -> dict:
    """The least time of one frontier-variant call at this mask: the bytes
    it must move -- the mask, labels and three outputs for every row; the
    row pointers, degree, noise row and edges (dst + w) of active rows
    only; pen in and M(l) out -- over the memory rate, against its
    operations (an add per active edge, ~5 per active (row, label)) over
    the float32 rate."""
    v = active.numel()
    need = torch.zeros(v + 1, dtype=torch.bool, device=active.device)
    need[:-1] |= active
    need[1:] |= active
    n_act = int(active.sum())
    edges = int((csr.row_ptr[1:] - csr.row_ptr[:-1])[active].sum())
    nbytes = (v * (1 + 4 + 12) + int(need.sum()) * 8
              + n_act * (4 + 4 * k) + edges * 8 + 2 * k * 4)
    ops = edges + 5 * k * n_act
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, active_rows=n_act, active_edges=edges,
                active_fraction=n_act / v)


def phase_frontier_kernel(graph, padded, labels_np: np.ndarray, dev,
                          report: dict) -> None:
    """(g1) The frontier variant at full size on (c)'s labels, and one
    frontier iteration split into its parts."""
    from repro_torch import rng
    from repro_torch.core import EngineOptions, SpinnerConfig, engine
    from repro_torch.kernels import ref
    from repro_torch.kernels.spinner_scores import (fused_update,
                                                    fused_update_frontier)

    cfg = SpinnerConfig(k=K)
    opts = EngineOptions(device=dev, engine="fused")
    bind, _ = engine.make_bind(graph, cfg, opts, dev, frontier=True)
    csr = padded.to_device(dev)
    v = padded.num_vertices
    labels = engine.pad_labels(torch.from_numpy(labels_np).to(dev), v)
    loads = engine.device_loads(labels, csr.deg_w, K)
    pen = loads / bind.capacity
    k_noise, k_mig = rng.split(rng.split(rng.PRNGKey(7))[1])
    noise = rng.uniform(k_noise, (v, K), 0.0, cfg.tie_noise, device=dev)
    u = rng.uniform(k_mig, (v,), device=dev)
    src, dst = edge_batch(graph.num_vertices, B1_PAIRS, seed=0)
    ends = torch.zeros(v, dtype=torch.bool, device=dev)
    ends[torch.from_numpy(np.concatenate([src, dst])).to(dev)] = True
    masks = {
        "dirty": (ends | engine.frontier_touched(ends, bind.frontier))
        & bind.valid,
        "random10": torch.from_numpy(np.random.default_rng(14).random(v)
                                     < 0.1).to(dev) & bind.valid}
    base = (csr.row_ptr, csr.dst, csr.weight)

    def variant(mask):
        return fused_update_frontier(labels, *base, csr.deg_w, pen, noise,
                                     mask, K, cfg.current_bonus, True)

    def plain(mask):
        return ref.frontier_propose_ref(labels, csr.src, csr.dst, csr.weight,
                                        csr.deg_w, pen, noise, mask, K,
                                        cfg.current_bonus, True)

    out = {}
    for name, mask in masks.items():
        got, want = variant(mask), plain(mask)
        torch.cuda.synchronize()
        check(float(want[3].max()) < 2**24, "M(l) reached 2^24")
        for field, a, b in zip(("best", "tot_best", "tot_cur", "m"), got,
                               want):
            check(bits_equal(a, b), f"fused_update_frontier_csr {field} != "
                  f"frontier_propose_ref ({name} mask)")
        off = ~mask
        check(torch.equal(got[0][off], labels[off])
              and not bool(got[1][off].any()) and not bool(got[2][off].any()),
              f"inactive rows not the no-op proposal ({name} mask)")
        err = max_abs_err(zip(got, want))
        del got, want
        bound = frontier_bound(csr, mask, K)
        out[name] = dict(max_abs_err=err,
                         ms=time_ms(lambda: variant(mask), reps=20),
                         plain_ms=time_ms(lambda: plain(mask), reps=5),
                         **bound)
        print(f"(g1) fused_update_frontier_csr, {name} mask (active "
              f"{bound['active_rows']} rows = "
              f"{bound['active_fraction']:.6f}, {bound['active_edges']} "
              f"edges): bitwise equal to the plain version (max_abs_err "
              f"{err}); {out[name]['ms']:.3f} ms, plain "
              f"{out[name]['plain_ms']:.3f} ms, bound "
              f"{bound['bound_ms']:.3f} ms for {bound['bytes']} B",
              flush=True)
    base_ms = time_ms(lambda: fused_update(
        labels, *base, csr.deg_w, pen, noise, bind.num_real, K,
        cfg.current_bonus, True), reps=20)
    print(f"(g1) the base form on the same labels: {base_ms:.3f} ms",
          flush=True)

    # one frontier iteration at the dirty mask, split into its parts
    _, finish = engine.make_update_parts(K, degree_weighted=True,
                                         current_bonus=cfg.current_bonus)
    mask = masks["dirty"]
    fbind = bind._replace(valid=mask)
    parts = variant(mask)
    new_labels = finish(*parts, labels, csr.deg_w, loads, u, mask,
                        bind.capacity)[0]
    changed = new_labels != labels
    step = engine.make_frontier_step(cfg, opts)
    state = engine.init_state(labels, loads, rng.PRNGKey(3))
    split = {
        "rng_ms": time_ms(lambda: (
            rng.uniform(k_noise, (v, K), 0.0, cfg.tie_noise, device=dev),
            rng.uniform(k_mig, (v,), device=dev)), reps=3, warmup=1),
        "kernel_ms": out["dirty"]["ms"],
        "expansion_ms": time_ms(lambda: engine.frontier_touched(
            changed, bind.frontier), reps=10),
        "epilogue_ms": time_ms(lambda: (
            finish(*parts, labels, csr.deg_w, loads, u, fbind.valid,
                   bind.capacity), (parts[0] != labels) & mask,
            mask.to(torch.float32).sum()), reps=10),
        "step_ms": time_ms(lambda: step(state, mask, bind), reps=3,
                           warmup=1),
    }
    print("(g1) one frontier iteration (dirty mask): " + " ".join(
        f"{k}={x:.3f}" for k, x in split.items()), flush=True)
    report["fused_update_frontier_csr"] = dict(
        out["dirty"], random10=out["random10"], base_form_ms=base_ms)
    report["frontier_split"] = split


def phase_session(graph, dev, report: dict) -> None:
    """(g2) The session on the full graph, on both score backends."""
    from repro_torch.core import EngineOptions, SpinnerConfig, open_session
    from repro_torch.kernels.spinner_scores import (fused_update,
                                                    fused_update_frontier,
                                                    spinner_scores)

    v, e = graph.num_vertices, graph.num_directed_entries
    b1 = edge_batch(v, B1_PAIRS, seed=0)
    b2 = edge_batch(v, B2_PAIRS, seed=1)
    runs = {}
    for backend in ("cuda", "torch"):
        s = open_session(graph, SpinnerConfig(k=K), EngineOptions(
            engine="fused", device=dev, score_backend=backend))
        calls = {}
        for name, call in (
                ("partition", lambda: s.partition()),
                ("adapt_b1_frontier",
                 lambda: s.adapt(edge_updates=b1, frontier=True)),
                ("adapt_b2", lambda: s.adapt(edge_updates=b2))):
            fused_update.launches = spinner_scores.launches = 0
            fused_update_frontier.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_var, n_base = fused_update_frontier.launches, \
                fused_update.launches
            st = s.stats()
            sent = st["delta"]["last_upload_bytes"] if name != "partition" \
                else 0
            calls[name] = dict(res=r, wall_s=wall, upload_bytes=sent,
                               variant_launches=n_var, base_launches=n_base)
            print(f"(g2) {backend} {name}: iterations={r.iterations} "
                  f"halted={r.halted} wall={wall:.3f}s "
                  f"kernel launches base={n_base} frontier={n_var}"
                  + (f" upload={sent} B ({sent / (12 * e):.6f} of 12*E)"
                     if name != "partition" else "")
                  + (f" uploads={st['uploads']}"), flush=True)
        st = s.stats()
        s.close()
        d = st["delta"]
        check(d["fast_adapts"] == 2 and d["host_rebuilds"] == 0
              and d["fallback_adapts"] == 0 and st["uploads"] <= 1,
              f"{backend} session: {d}, uploads {st['uploads']}")
        front = calls["adapt_b1_frontier"]
        if backend == "cuda":
            check(front["variant_launches"] == front["res"].iterations >= 1
                  and front["base_launches"] == 0,
                  f"frontier variant launched {front['variant_launches']} "
                  f"times in {front['res'].iterations} iterations")
            for name in ("partition", "adapt_b2"):
                check(calls[name]["base_launches"]
                      == calls[name]["res"].iterations,
                      f"{name}: fused kernel launches != iterations")
        else:
            check(all(c["variant_launches"] == c["base_launches"] == 0
                      for c in calls.values()), "torch session launched")
        runs[backend] = (calls, d)
    for name in runs["cuda"][0]:
        a, b = runs["cuda"][0][name]["res"], runs["torch"][0][name]["res"]
        check(np.array_equal(a.labels, b.labels)
              and np.array_equal(a.loads, b.loads)
              and (a.iterations, a.halted, a.scored_per_iter)
              == (b.iterations, b.halted, b.scored_per_iter),
              f"{name}: cuda and torch sessions diverged")
    check(runs["cuda"][1] == runs["torch"][1], "delta counters differ")
    front = runs["cuda"][0]["adapt_b1_frontier"]["res"]
    frac = [x / v for x in front.scored_per_iter]
    below = next((i + 1 for i, x in enumerate(frac) if x < 0.005), None)
    print(f"(g2) cuda and torch sequences identical; delta counters "
          f"{runs['cuda'][1]}; frontier scored fraction at iteration "
          + ", ".join(f"{i}: {frac[i - 1]:.6f}" for i in
                      (1, 2, 3, 5, 10, 20, 50, 100, 200, 300)
                      if i <= len(frac))
          + f"; below 0.5% from iteration {below}; mean "
          f"{statistics.mean(frac):.6f} over {len(frac)}", flush=True)
    report["session"] = {
        backend: {name: dict(iterations=c["res"].iterations,
                             halted=c["res"].halted, wall_s=c["wall_s"],
                             upload_bytes=c["upload_bytes"])
                  for name, c in calls.items()}
        for backend, (calls, _) in runs.items()}
    report["session"]["frontier_scored_fraction"] = frac
    report["fused_update_frontier_csr"]["launches"] = \
        runs["cuda"][0]["adapt_b1_frontier"]["variant_launches"]
    report["session_torch"] = {name: c["res"]
                               for name, c in runs["torch"][0].items()}


def phase_session_medium(g, dev) -> None:
    """(g3) On the medium graph: the fast path's dense adapt against the
    rebuilt graph's run (the fallback oracle)."""
    from repro_torch.core import (EngineOptions, SpinnerConfig, add_edges,
                                  open_session)

    cfg = SpinnerConfig(k=K)
    opts = EngineOptions(engine="fused", device=dev)
    batch = edge_batch(g.num_vertices, 16_000, seed=2)
    s = open_session(g, cfg, opts)
    base = s.partition()
    fast = s.adapt(edge_updates=batch, frontier=False)
    d = s.stats()["delta"]
    check(d["fast_adapts"] == 1 and d["host_rebuilds"] == 0,
          f"medium fast path not taken: {d}")
    oracle = open_session(add_edges(g, *batch), cfg, opts).adapt(
        prev=base.labels)
    check(np.array_equal(fast.labels, oracle.labels)
          and np.array_equal(fast.loads, oracle.loads)
          and fast.iterations == oracle.iterations,
          "medium fast adapt differs from the rebuilt graph's run")
    print(f"(g3) medium V={g.num_vertices}: fast adapt of 16,000 pairs "
          f"identical to the rebuilt graph's run ({fast.iterations} "
          f"iterations)", flush=True)


def shard_bytes(rows: int, edges: int, lookup_read: int, k: int,
                seeded: bool, fused: bool) -> int:
    """The bytes a score-kernel call on one shard's CSR must move: row_ptr
    (8 B/row), dst and w (8 B/edge), the lookup entries its edges read
    (4 B each, counted once); the score kernel writes (rows, k) f32; the
    fused kernel reads the own labels, degrees, pen and (rows, k) noise --
    the seeded form the (rows, k) partial too -- and writes three (rows,)
    vectors and M(l)."""
    nbytes = (rows + 1) * 8 + edges * 8 + lookup_read * 4
    if not fused:
        return nbytes + rows * k * 4
    nbytes += rows * 4 + rows * 4 + k * 4 + rows * k * 4 + 3 * rows * 4 + k * 4
    return nbytes + (rows * k * 4 if seeded else 0)


def phase_sharded_kernels(padded, num_real: int, labels_np: np.ndarray,
                          dev, report: dict) -> None:
    """(h1) K1's seeded form at a real frontier: the 4-way layout of the
    full graph, each shard's interior partial (K2) then the seeded kernel
    over its frontier, against the plain version and the base kernel over
    the whole shard."""
    from repro_torch import rng
    from repro_torch.core import distributed, engine
    from repro_torch.kernels import ref
    from repro_torch.kernels.spinner_scores import (fused_update,
                                                    fused_update_seeded,
                                                    spinner_scores)

    ndev, v = 4, padded.num_vertices
    lookup = engine.pad_labels(torch.from_numpy(labels_np).to(dev), v)
    deg_all = padded.to_device(dev).deg_w
    loads = engine.device_loads(lookup, deg_all, K)
    pen = loads / torch.tensor(1.05 * padded.total_weight / K,
                               dtype=torch.float32, device=dev)
    key = rng.split(rng.PRNGKey(21))[0]
    shards, err = [], 0.0
    for rank in range(ndev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sh = distributed.rank_shard(padded, ndev, rank, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        vl, off = sh.v_local, sh.offset
        labels = lookup[off:off + vl].contiguous()
        noise = rng.uniform(key, (vl, K), 0.0, 1e-7, device=dev,
                            offset=off * K)
        rp_i, src_i, d_i, w_i = sh.interior
        rp_f, src_f, d_f, w_f = sh.frontier
        common = (sh.deg_w, pen, noise, min(num_real - off, vl), K, 1e-6,
                  True)

        def interior():
            return spinner_scores(labels, rp_i, d_i, w_i, K)

        partial = interior()
        plain_partial = ref.interior_partial_ref(labels, rp_i, d_i, w_i, K)
        torch.cuda.synchronize()
        check(bits_equal(partial, plain_partial),
              f"shard {rank}: interior partial != plain")
        del plain_partial

        def seeded():
            return fused_update_seeded(labels, rp_f, d_f, w_f, *common,
                                       partial, lookup=lookup)

        def plain():
            return ref.fused_propose_ref(labels, src_f, d_f, w_f, *common,
                                         lookup=lookup, acc_init=partial)

        def base():
            return fused_update(labels, sh.whole[0], sh.whole[2],
                                sh.whole[3], *common, lookup=lookup)

        got, want, whole = seeded(), plain(), base()
        torch.cuda.synchronize()
        check(float(want[3].max()) < 2**24, "M(l) reached 2^24")
        for name, a, b, c in zip(("best", "tot_best", "tot_cur", "m"), got,
                                 want, whole):
            check(bits_equal(a, b), f"shard {rank}: fused_update_seeded_csr "
                  f"{name} != plain")
            check(bits_equal(a, c), f"shard {rank}: fused_update_seeded_csr "
                  f"{name} != fused_update_csr over the whole shard")
        err = max(err, max_abs_err(zip(got, want)))
        del got, want, whole
        n_i, n_f = d_i.numel(), d_f.numel()
        reads_i = int(torch.unique(d_i).numel())
        reads_f = int(torch.unique(d_f).numel())
        reads_w = int(torch.unique(sh.whole[2]).numel())
        row = dict(
            rank=rank, rows=vl, interior_edges=n_i, frontier_edges=n_f,
            frontier_fraction=n_f / max(n_i + n_f, 1), build_s=build_s,
            interior_ms=time_ms(interior, reps=20),
            seeded_ms=time_ms(seeded, reps=20),
            base_ms=time_ms(base, reps=20),
            plain_seeded_ms=time_ms(plain, reps=3, warmup=1),
            interior_bound_ms=shard_bytes(vl, n_i, reads_i, K, False, False)
            / HBM_BYTES_PER_S * 1e3,
            seeded_bound_ms=shard_bytes(vl, n_f, reads_f, K, True, True)
            / HBM_BYTES_PER_S * 1e3,
            base_bound_ms=shard_bytes(vl, n_i + n_f, reads_w, K, False, True)
            / HBM_BYTES_PER_S * 1e3)
        shards.append(row)
        print(f"(h1) shard {rank}/{ndev}: {vl} rows, {n_i} interior + {n_f} "
              f"frontier entries ({row['frontier_fraction']:.4f}), built in "
              f"{build_s:.3f}s; interior partial + fused_update_seeded_csr "
              f"bitwise equal to the plain version and to fused_update_csr "
              f"over the whole shard; interior {row['interior_ms']:.3f} ms "
              f"(bound {row['interior_bound_ms']:.3f}), seeded "
              f"{row['seeded_ms']:.3f} ms (bound {row['seeded_bound_ms']:.3f},"
              f" plain {row['plain_seeded_ms']:.3f}), base over the shard "
              f"{row['base_ms']:.3f} ms (bound {row['base_bound_ms']:.3f})",
              flush=True)
        del partial, noise
    report["sharded_shards"] = shards
    report["seeded_shard_err"] = err


def phase_sharded_main(graph, fused_res: dict, dev, report: dict) -> None:
    """(h2) ``partition(engine="sharded")`` of the full graph at world size
    1, overlap on and off, against (c)'s fused run; the seeded kernel at
    that run's shapes; one iteration split into its parts."""
    from repro_torch import rng
    from repro_torch.core import EngineOptions, SpinnerConfig, engine
    from repro_torch.core import partition
    from repro_torch.kernels import ref
    from repro_torch.kernels.spinner_scores import (fused_update,
                                                    fused_update_seeded,
                                                    spinner_scores)
    from repro_torch.launch.mesh import make_partition_mesh

    cfg = SpinnerConfig(k=K)
    mesh = make_partition_mesh(1, device=dev)
    runs = {}
    for overlap in ("on", "off"):
        opts = EngineOptions(overlap=overlap, device=dev)
        fused_update.launches = fused_update_seeded.launches = 0
        spinner_scores.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = partition(graph, cfg, engine="sharded", mesh=mesh,
                        options=opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_seed, n_base, n_k2 = (fused_update_seeded.launches,
                                fused_update.launches,
                                spinner_scores.launches)
        check(np.array_equal(res.labels, fused_res["labels"])
              and np.array_equal(res.loads, fused_res["loads"])
              and (res.iterations, res.halted)
              == (fused_res["iterations"], fused_res["halted"]),
              f"sharded overlap={overlap} differs from (c)'s fused run")
        check(res.exchanged_bytes == 0.0, "bytes exchanged at world size 1")
        if overlap == "on":
            check(n_seed == n_k2 == res.iterations and n_base == 0,
                  f"overlap: seeded {n_seed}, score {n_k2}, base {n_base} "
                  f"launches in {res.iterations} iterations")
        else:
            check(n_base == res.iterations and n_seed == n_k2 == 0,
                  f"no overlap: base {n_base}, seeded {n_seed} launches in "
                  f"{res.iterations} iterations")
        runs[overlap] = dict(iterations=res.iterations, halted=res.halted,
                             wall_s=wall, seeded_launches=n_seed,
                             interior_launches=n_k2, base_launches=n_base,
                             ms_per_iteration=wall / res.iterations * 1e3)
        print(f"(h2) partition(engine='sharded', overlap={overlap!r}) at "
              f"world size 1: iterations={res.iterations} halted="
              f"{res.halted} wall={wall:.3f}s ms/iteration="
              f"{wall / res.iterations * 1e3:.3f} exchanged_bytes="
              f"{res.exchanged_bytes} launches seeded={n_seed} interior="
              f"{n_k2} base={n_base}; identical to (c)'s fused run",
              flush=True)

    # the seeded kernel at the main path's shapes (every edge interior, an
    # empty frontier), and one iteration split into its parts
    opts = EngineOptions(overlap="on", device=dev)
    _, plan, step, bind, comm = engine._sharded_parts(graph, cfg, opts, mesh)
    v = bind.deg_w.shape[0]
    labels = engine.pad_labels(torch.from_numpy(fused_res["labels"]).to(dev),
                               v)
    loads = torch.from_numpy(fused_res["loads"]).to(dev)
    pen = loads / bind.capacity
    k_noise, k_mig = rng.split(rng.split(rng.PRNGKey(5))[1])
    noise = rng.uniform(k_noise, (v, K), 0.0, cfg.tie_noise, device=dev)
    u = rng.uniform(k_mig, (v,), device=dev)
    rp_f, d_f, w_f = bind.score[3:]
    common = (bind.deg_w, pen, noise, bind.num_real_local, K,
              cfg.current_bonus, True)

    def interior():
        return spinner_scores(labels, *bind.score[:3], K)

    partial = interior()

    def seeded():
        return fused_update_seeded(labels, rp_f, d_f, w_f, *common, partial,
                                   lookup=labels)

    def plain():
        return ref.fused_propose_ref(labels, ref.csr_src(rp_f), d_f, w_f,
                                     *common, lookup=labels,
                                     acc_init=partial)

    got, want = seeded(), plain()
    torch.cuda.synchronize()
    for name, a, b in zip(("best", "tot_best", "tot_cur", "m"), got, want):
        check(bits_equal(a, b), f"fused_update_seeded_csr {name} != plain "
              f"at the main path's shapes")
    err = max_abs_err(zip(got, want))
    _, finish = engine.make_update_parts(K, degree_weighted=True,
                                         current_bonus=cfg.current_bonus)
    reduce_ = engine.make_rank_sum(comm)
    state = engine.init_state(labels, loads, rng.PRNGKey(3))
    split = {
        "rng_ms": time_ms(lambda: (
            rng.uniform(k_noise, (v, K), 0.0, cfg.tie_noise, device=dev,
                        offset=0),
            rng.uniform(k_mig, (v,), device=dev, offset=0)), reps=3,
            warmup=1),
        "interior_ms": time_ms(interior, reps=20),
        "exchange_ms": time_ms(lambda: plan.exchange(
            labels, (), comm, *bind.plan_args), reps=20),
        "seeded_ms": time_ms(seeded, reps=20),
        "epilogue_ms": time_ms(lambda: finish(
            *got, labels, bind.deg_w, loads, u, bind.valid, bind.capacity,
            reduce_), reps=10),
        "step_ms": time_ms(lambda: step(state, (), bind), reps=3, warmup=1),
    }
    nbytes = shard_bytes(v, d_f.numel(), 0, K, True, True)
    seeded_row = dict(
        launches=runs["on"]["seeded_launches"], max_abs_err=err,
        ms=split["seeded_ms"], plain_ms=time_ms(plain, reps=5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bytes=nbytes)
    print(f"(h2) fused_update_seeded_csr at the main path's shapes (V_pad="
          f"{v}, frontier {d_f.numel()} entries): bitwise equal to the plain "
          f"version; {seeded_row['ms']:.3f} ms, plain "
          f"{seeded_row['plain_ms']:.3f} ms, bound "
          f"{seeded_row['bound_ms']:.3f} ms for {nbytes} B", flush=True)
    print("(h2) one sharded iteration (overlap, world size 1): " + " ".join(
        f"{k}={x:.3f}" for k, x in split.items()), flush=True)
    report["fused_update_seeded_csr"] = seeded_row
    report["sharded_main"] = dict(runs, split=split)


def phase_sharded_medium(g, base: np.ndarray, dev, report: dict) -> None:
    """(h3) The medium graph at world size 1: every plan x overlap x score
    backend identical to (d)'s run."""
    from repro_torch.core import EngineOptions, SpinnerConfig, partition
    from repro_torch.launch.mesh import make_partition_mesh

    mesh = make_partition_mesh(1, device=dev)
    want = report["medium_result"]
    n = 0
    t0 = time.perf_counter()
    for plan in ("allgather", "halo", "halo_delta", "delta"):
        for overlap in ("on", "off"):
            for backend in ("cuda", "torch"):
                r = partition(g, SpinnerConfig(k=K), engine="sharded",
                              mesh=mesh, options=EngineOptions(
                                  label_exchange=plan, overlap=overlap,
                                  score_backend=backend, device=dev))
                check(np.array_equal(r.labels, base)
                      and np.array_equal(r.loads, want["loads"])
                      and (r.iterations, r.halted)
                      == (want["iterations"], want["halted"])
                      and r.exchanged_bytes == 0.0,
                      f"medium sharded {plan}/{overlap}/{backend} differs "
                      f"from (d)")
                n += 1
    print(f"(h3) medium V={g.num_vertices}: {n} sharded runs (allgather/halo/"
          f"halo_delta/delta x overlap on/off x cuda/torch) identical to "
          f"(d)'s run ({want['iterations']} iterations) in "
          f"{time.perf_counter() - t0:.3f}s", flush=True)


def phase_apps_mesh_kernels(graph, labels: np.ndarray, dev,
                            report: dict) -> None:
    """(i1) K3 then K4 on each rank of the full graph's 4-way app layout,
    for (c)'s Spinner labels and the hash labels: K3 over the rank's
    interior, K4 over its frontier (the whole send vector as the lookup,
    the allgather/delta index) seeded by K3's partial, for PageRank's sum
    and WCC's min; held to the plain versions and timed beside their
    bounds; the halo each placement would exchange, counted on the card."""
    from repro_torch.apps import APPS, build_app_layout, init_values
    from repro_torch.kernels import ref
    from repro_torch.kernels.pregel_combine import (pregel_combine,
                                                    pregel_reduce)

    ndev = 4
    placements = {"spinner": labels,
                  "hash": hash_labels(graph.num_vertices, K)}
    out, errs = {}, {"pregel_reduce_csr": 0.0, "pregel_combine_csr": 0.0}

    def hold(name, combine, got, again, want):
        torch.cuda.synchronize()
        for a, b, c in zip(got, again, want):
            check(bits_equal(a, b), f"(i1) {name} ({combine}) differs "
                  f"between two launches")
            if combine == "min" or a.dtype == torch.bool:
                check(bits_equal(a, c), f"(i1) {name} ({combine}) != plain")
            else:
                check(bool(torch.allclose(a, c, rtol=1e-5, atol=1e-9)),
                      f"(i1) {name} ({combine}) outside rtol 1e-5 of plain")
        errs[name] = max(errs[name], max_abs_err(zip(got, want)))

    for name, lab in placements.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lay = build_app_layout(graph, lab, dev, ndev=ndev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        vl, base = lay.v_per_dev, float(np.float32(0.15 / lay.num_real))
        pr0 = torch.from_numpy(init_values(APPS["pagerank"], lay)).to(dev)
        wcc0 = torch.from_numpy(init_values(APPS["wcc"], lay)).to(dev)
        cases = (("sum", "pagerank", pr0 / torch.clamp(lay.deg_cnt, min=1.0),
                  pr0), ("min", "min", wcc0, wcc0))
        shards = []
        for rank in range(ndev):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sh = lay.shard(rank)
            torch.cuda.synchronize()
            rows = slice(sh.offset, sh.offset + vl)
            n_i, n_f = sh.interior[1].numel(), sh.frontier[1].numel()
            reads_i = int(torch.unique(sh.interior[1]).numel())
            reads_f = int(torch.unique(sh.frontier[1]).numel())
            row = dict(rank=rank, rows=vl, interior_edges=n_i,
                       frontier_edges=n_f,
                       frontier_fraction=n_f / max(n_i + n_f, 1),
                       shard_build_s=time.perf_counter() - t0)
            check(n_f > 0, f"(i1) {name} rank {rank}: empty frontier")
            for combine, update, send, values in cases:
                kw = dict(combine=combine)
                ckw = dict(kw, update=update, damping=0.85)
                own = send[rows]

                def interior():
                    return pregel_reduce(own, *sh.interior, **kw)

                partial = interior()
                hold("pregel_reduce_csr", combine, (partial,), (interior(),),
                     (ref.pregel_reduce_ref(own, *sh.interior, **kw),))
                args = (send, *sh.frontier, values[rows], sh.valid, base)

                def frontier():
                    return pregel_combine(*args, acc_init=partial, **ckw)

                hold("pregel_combine_csr", combine, frontier(), frontier(),
                     ref.pregel_combine_ref(*args, acc_init=partial, **ckw))
                sfx = "" if combine == "sum" else "_min"
                row.update({
                    "k3_ms" + sfx: time_ms(interior, reps=20),
                    "k4_ms" + sfx: time_ms(frontier, reps=20),
                    "k3_plain_ms" + sfx: time_ms(
                        lambda: ref.pregel_reduce_ref(own, *sh.interior,
                                                      **kw), reps=3,
                        warmup=1),
                    "k4_plain_ms" + sfx: time_ms(
                        lambda: ref.pregel_combine_ref(
                            *args, acc_init=partial, **ckw), reps=3,
                        warmup=1),
                    "k3_bound_ms" + sfx: pregel_bound(
                        *sh.interior, combine, False, False,
                        lookup_read=reads_i)["bound_ms"],
                    "k4_bound_ms" + sfx: pregel_bound(
                        *sh.frontier, combine, True, True,
                        lookup_read=reads_f)["bound_ms"]})
                del partial
            shards.append(row)
            print(f"(i1) {name} rank {rank}/{ndev}: {vl} rows, {n_i} interior "
                  f"+ {n_f} frontier entries ({row['frontier_fraction']:.4f}"
                  f"), shard built in {row['shard_build_s']:.3f}s; K3 interior"
                  f" then K4 frontier equal to the plain versions; sum K3 "
                  f"{row['k3_ms']:.3f} ms (bound {row['k3_bound_ms']:.3f}, "
                  f"plain {row['k3_plain_ms']:.3f}) K4 {row['k4_ms']:.3f} ms "
                  f"(bound {row['k4_bound_ms']:.3f}, plain "
                  f"{row['k4_plain_ms']:.3f}); min K3 {row['k3_ms_min']:.3f} "
                  f"(bound {row['k3_bound_ms_min']:.3f}) K4 "
                  f"{row['k4_ms_min']:.3f} (bound {row['k4_bound_ms_min']:.3f}"
                  f")", flush=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        halo = lay.halo_count()
        halo_s = time.perf_counter() - t0
        out[name] = dict(layout_build_s=build_s, shards=shards, halo=halo,
                         halo_count_s=halo_s,
                         halo_wire_bytes_per_superstep=halo * 4,
                         allgather_wire_bytes_per_superstep=(ndev - 1)
                         * lay.v_pad * 4)
        print(f"(i1) {name}: 4-way layout built on the card in {build_s:.3f}s;"
              f" halo {halo} (owner, remote vertex) pairs, counted on the card"
              f" in {halo_s:.3f}s = {halo * 4} B a PageRank superstep under "
              f"the halo plan (allgather: "
              f"{out[name]['allgather_wire_bytes_per_superstep']} B)",
              flush=True)
    s_b, h_b = (out[n]["halo_wire_bytes_per_superstep"]
                for n in ("spinner", "hash"))
    check(s_b < h_b, f"(i1) Spinner's halo {s_b} B not below hash's {h_b} B")
    print(f"(i1) halo wire bytes a PageRank superstep, Spinner / hash: "
          f"{s_b} / {h_b} = {s_b / h_b:.4f}", flush=True)
    report["apps_mesh_shards"] = out
    report["apps_mesh_err"] = errs


def phase_apps_mesh_main(graph, labels: np.ndarray, dev,
                         report: dict) -> None:
    """(i2) ``run_app(mesh=make_partition_mesh(1))`` of the full graph on the
    Spinner placement: PageRank, WCC and BFS with the allgather plan,
    overlap on and off, identical to (f)'s runs, K3 and K4 launched once
    per superstep; then one superstep split into its parts."""
    from repro_torch.apps import APPS, build_app_layout, init_values, run_app
    from repro_torch.core.comm import Comm
    from repro_torch.kernels.pregel_combine import (pregel_combine,
                                                    pregel_reduce)
    from repro_torch.launch.mesh import make_partition_mesh, mesh_group

    mesh = make_partition_mesh(1, device=dev)
    want = report["app_results"]
    runs, launches = {}, 0
    for wl, kw in (("pagerank", dict(iters=PAGERANK_ITERS)), ("wcc", {}),
                   ("bfs", dict(source=0))):
        w = want[wl]
        for overlap in (True, False):
            pregel_reduce.launches = pregel_combine.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = run_app(graph, labels, wl, mesh=mesh, plan="allgather",
                        overlap=overlap, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n3, n4 = pregel_reduce.launches, pregel_combine.launches
            check(np.array_equal(r.values, w.values)
                  and (r.supersteps, r.converged) == (w.supersteps,
                                                      w.converged)
                  and np.array_equal(r.device_messages, w.device_messages),
                  f"(i2) {wl} overlap={overlap} differs from (f)'s run")
            check(r.wire_bytes == 0.0 and r.plan == "allgather"
                  and r.ndev == 1, f"(i2) {wl}: {r.wire_bytes} B on the wire")
            check(n3 == n4 == r.supersteps, f"(i2) {wl}: kernels launched "
                  f"{n3}/{n4} times in {r.supersteps} supersteps")
            launches += n3
            runs[f"{wl}/overlap={overlap}"] = dict(
                supersteps=r.supersteps, wall_s=wall,
                ms_per_superstep=wall / r.supersteps * 1e3)
            print(f"(i2) run_app({wl!r}, mesh=1 rank, plan='allgather', "
                  f"overlap={overlap}): supersteps={r.supersteps} wall="
                  f"{wall:.3f}s ms/superstep={wall / r.supersteps * 1e3:.3f} "
                  f"wire_bytes={r.wire_bytes} launches={n3}+{n4}; identical "
                  f"to (f)'s run", flush=True)

    # one PageRank superstep (overlap) split into its parts
    lay = build_app_layout(graph, labels, dev)
    plan = lay.exchange_plan(graph, "allgather")
    comm = Comm(group=mesh_group(mesh), rank=0, ndev=1)
    args = plan.device_args(0, dev)
    sh = lay.shard(0, plan)
    values = torch.from_numpy(init_values(APPS["pagerank"], lay)).to(dev)
    share = torch.clamp(sh.deg_cnt, min=1.0)
    send = values / share
    base = float(np.float32(0.15 / lay.num_real))
    partial = pregel_reduce(send, *sh.interior, combine="sum")
    split = {
        "send_ms": time_ms(lambda: values / share, reps=20),
        "k3_ms": time_ms(lambda: pregel_reduce(send, *sh.interior,
                                               combine="sum"), reps=20),
        "exchange_ms": time_ms(lambda: plan.exchange(send, (), comm, *args),
                               reps=20),
        "k4_ms": time_ms(lambda: pregel_combine(
            send, *sh.frontier, values, sh.valid, base, combine="sum",
            update="pagerank", damping=0.85, acc_init=partial), reps=20)}
    print("(i2) one PageRank superstep (world size 1, allgather): " + " ".join(
        f"{k}={x:.3f}" for k, x in split.items()), flush=True)
    report["apps_mesh_main"] = dict(runs, split=split, launches=launches)


def phase_apps_mesh_medium(g, labels: np.ndarray, dev) -> None:
    """(i3) The medium graph at world size 1: every workload x plan x
    overlap x combine identical to the single-device run (PageRank on the
    plain versions within rtol 1e-4: their float sums repeat no order on
    the card); the halo of the 4-way layout counted on the card equal to
    ``HaloPlan.true_halo``."""
    from repro_torch.apps import build_app_layout, run_app
    from repro_torch.launch.mesh import make_partition_mesh

    mesh = make_partition_mesh(1, device=dev)
    n = 0
    t0 = time.perf_counter()
    for wl in ("pagerank", "wcc", "bfs", "sssp"):
        for combine in ("cuda", "torch"):
            want = run_app(g, labels, wl, combine=combine, device=dev)
            for plan in ("allgather", "halo", "halo_delta", "delta"):
                for overlap in (True, False):
                    r = run_app(g, labels, wl, mesh=mesh, plan=plan,
                                overlap=overlap, combine=combine)
                    # the plain sum is index_add_, whose float order on
                    # the card changes run to run: PageRank on "torch"
                    # within the repo's PageRank tolerance
                    same = (bool(np.allclose(r.values, want.values,
                                             rtol=1e-4, atol=1e-9))
                            if (wl, combine) == ("pagerank", "torch")
                            else np.array_equal(r.values, want.values))
                    check(same and r.supersteps == want.supersteps
                          and np.array_equal(r.device_messages,
                                             want.device_messages)
                          and r.wire_bytes == 0.0,
                          f"(i3) medium {wl}/{plan}/{overlap}/{combine} "
                          f"differs from the single-device run")
                    n += 1
    print(f"(i3) medium V={g.num_vertices}: {n} run_app calls on a one-rank "
          f"mesh (pagerank/wcc/bfs/sssp x allgather/halo/halo_delta/delta x "
          f"overlap on/off x cuda/torch) identical to the single-device runs "
          f"(PageRank on torch within rtol 1e-4) in "
          f"{time.perf_counter() - t0:.3f}s", flush=True)
    for name, lab in (("spinner", labels),
                      ("hash", hash_labels(g.num_vertices, K))):
        lay = build_app_layout(g, lab, dev, ndev=4)
        card, host = lay.halo_count(), lay.exchange_plan(g, "halo").true_halo
        check(card == host, f"(i3) {name}: halo {card} on the card, "
              f"{host} from HaloPlan")
        print(f"(i3) medium {name} 4-way layout: halo {card} on the card = "
              f"HaloPlan.true_halo {host}", flush=True)


MESH_MEDIUM_ITERS = 5      # (j2)'s depth: its CPU side draws ~1.5 s an
                           # iteration at the medium size


def _launch_counts() -> tuple:
    from repro_torch.kernels.spinner_scores import (fused_update,
                                                    fused_update_frontier,
                                                    fused_update_seeded,
                                                    spinner_scores)
    return tuple(f.launches for f in (fused_update, fused_update_frontier,
                                      fused_update_seeded, spinner_scores))


def phase_mesh_session(graph, dev, smi: str, report: dict) -> None:
    """(j1) Continuous partitioning of the full graph on a one-rank NCCL
    mesh: the torch backend's session, both adapts on the fast path, held
    to (g2)'s torch-backend run; one sharded frontier iteration split into
    its parts."""
    from repro_torch import rng
    from repro_torch.core import (EngineOptions, SpinnerConfig, engine,
                                  open_session, partitioning_difference)
    from repro_torch.launch.mesh import make_partition_mesh

    v, e = graph.num_vertices, graph.num_directed_entries
    b1 = edge_batch(v, B1_PAIRS, seed=0)
    b2 = edge_batch(v, B2_PAIRS, seed=1)
    cfg = SpinnerConfig(k=K)
    opts = EngineOptions(mesh=make_partition_mesh(1, device=dev), device=dev,
                         score_backend="torch", overlap="off")
    s = open_session(graph, cfg, opts)
    calls, prev = {}, None
    for name, call in (
            ("partition", lambda: s.partition()),
            ("adapt_b1_frontier",
             lambda: s.adapt(edge_updates=b1, frontier=True)),
            ("adapt_b2", lambda: s.adapt(edge_updates=b2))):
        n0 = _launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(_launch_counts() == n0, f"(j1) {name} launched a CUDA kernel "
              "on the torch backend")
        d = s.stats()["delta"]
        sent = d["last_upload_bytes"] if name != "partition" else 0
        frac = (sum(r.scored_per_iter) / (v * r.iterations)
                if r.scored_per_iter else 1.0)
        moved = (partitioning_difference(prev, r.labels)
                 if prev is not None else None)
        calls[name] = dict(res=r, wall_s=wall, upload_bytes=sent,
                           scored_fraction=frac, moved=moved)
        print(f"(j1) mesh session {name} [{smi}]: engine={r.engine} "
              f"iterations={r.iterations} halted={r.halted} wall="
              f"{wall:.3f}s scored fraction {frac:.6f} moved from the "
              f"previous labels {moved} exchanged_bytes={r.exchanged_bytes}"
              + (f" upload={sent} B ({sent / (12 * e):.6f} of 12*E)"
                 if name != "partition" else ""), flush=True)
        prev = r.labels
    d = s.stats()["delta"]
    check(d["fast_adapts"] == 2 and d["fallback_adapts"] == 0
          and d["host_rebuilds"] == 0, f"(j1) not both fast: {d}")
    for name, pairs in (("adapt_b1_frontier", B1_PAIRS),
                        ("adapt_b2", B2_PAIRS)):
        check(0 < calls[name]["upload_bytes"] <= 12 * 2 * pairs,
              f"(j1) {name} uploaded more than 12 bytes an entry")
    want = report["session_torch"]
    for name, c in calls.items():
        a, b = c["res"], want[name]
        check(np.array_equal(a.labels, b.labels)
              and np.array_equal(a.loads, b.loads)
              and (a.iterations, a.halted, a.scored_per_iter)
              == (b.iterations, b.halted, b.scored_per_iter),
              f"(j1) {name} differs from (g2)'s torch-backend run")
    print(f"(j1) the three calls identical to (g2)'s torch-backend session "
          f"(labels, loads, iterations, scored_per_iter); delta counters "
          f"{d}", flush=True)

    # one sharded frontier iteration on the merged graph's base layout,
    # split into its parts (B1's dirty set, on the labels after B2)
    _, plan, step, bind, comm = engine._sharded_parts(
        graph, cfg, opts, opts.mesh, frontier=True)
    vl = bind.deg_w.shape[0]
    labels = engine.pad_labels(torch.from_numpy(prev).to(dev), vl)
    loads = engine.device_loads(labels, bind.deg_w, K)
    active = torch.zeros(vl, dtype=torch.bool, device=dev)
    active[torch.from_numpy(np.concatenate(b1)).to(dev)] = True
    k_noise, k_mig = rng.split(rng.split(rng.PRNGKey(11))[1])
    draws = engine._sharded_draws(cfg, comm, vl, "replicated")
    lookup, aux, _ = plan.prime(labels, comm, *bind.plan_args)
    changed = active.clone()          # as if B1's endpoints had moved
    scores_fn = opts.backend().make_sharded_scores(K, vl)
    propose, finish = engine.make_update_parts(
        K, degree_weighted=True, current_bonus=cfg.current_bonus)
    reduce_ = engine.make_rank_sum(comm)
    noise, u = draws(k_noise, bind, dev)
    scores = scores_fn(lookup, labels, bind)
    valid = bind.valid & active
    state = engine.init_state(labels, loads, rng.PRNGKey(3))

    def epilogue():
        parts = propose(scores, labels, bind.deg_w, loads, noise, valid,
                        bind.capacity)
        finish(*parts, labels, bind.deg_w, loads, u, valid, bind.capacity,
               reduce_)
        reduce_([valid.to(torch.float32).sum(),
                 ((parts[0] != labels) & valid).sum().to(torch.int32)])

    split = {
        "draws_ms": time_ms(lambda: draws(k_mig, bind, dev), reps=3,
                            warmup=1),
        "exchange_ms": time_ms(lambda: plan.exchange(
            labels, aux, comm, *bind.plan_args), reps=10),
        "expansion_ms": time_ms(lambda: engine.frontier_touched(
            changed, bind.frontier, rows=vl), reps=5),
        "scores_ms": time_ms(lambda: scores_fn(lookup, labels, bind),
                             reps=3, warmup=1),
        "epilogue_ms": time_ms(epilogue, reps=5),
        "step_ms": time_ms(lambda: step(state, aux, active, lookup, bind),
                           reps=3, warmup=1),
    }
    del scores, noise
    print(f"(j1) one sharded frontier iteration (torch backend, world size "
          f"1) [{smi}]: " + " ".join(f"{k}={x:.3f}" for k, x in
                                    split.items()), flush=True)
    report["mesh_session"] = dict(
        {name: {k: x for k, x in c.items() if k != "res"}
         | dict(iterations=c["res"].iterations, halted=c["res"].halted)
         for name, c in calls.items()}, split=split, card=smi)


def phase_mesh_medium(g, base: np.ndarray, dev, smi: str) -> None:
    """(j2) The medium graph from (d)'s labels: every plan x fused on/off x
    noise mode of the mesh session on the card, each bitwise equal to the
    CPU run of the same calls for its noise mode (the CPU tests hold every
    plan and fused form to one trajectory per noise mode); the halo plans
    fall back; a batch that overflows the slack falls back; the CUDA
    backend's frontier adapt raises."""
    from repro_torch.core import EngineOptions, SpinnerConfig, open_session
    from repro_torch.launch.mesh import make_partition_mesh

    cfg = SpinnerConfig(k=K, max_iters=MESH_MEDIUM_ITERS)
    v = g.num_vertices
    b1, b2 = edge_batch(v, 4_000, seed=3), edge_batch(v, 16_000, seed=4)
    # 1.2 M entries: more than the edge bucket's ~0.94 M spare slots
    big = edge_batch(v, 600_000, seed=5)
    meshes = {"card": make_partition_mesh(1, device=dev),
              "cpu": make_partition_mesh(device="cpu")}

    def run(where, plan, fused, noise, backend="torch", overflow=False):
        s = open_session(g, cfg, EngineOptions(
            mesh=meshes[where], device=dev if where == "card" else "cpu",
            label_exchange=plan, fused_update=fused, sharded_noise=noise,
            score_backend=backend, overlap="off"))
        out = [s.adapt(edge_updates=b1, frontier=True, prev=base)]
        out.append(s.adapt(edge_updates=big if overflow else b2))
        return out, s.stats()["delta"]

    def same(a, b):
        return all(np.array_equal(x.labels, y.labels)
                   and np.array_equal(x.loads, y.loads)
                   and (x.iterations, x.halted, x.scored_per_iter,
                        x.exchanged_bytes) == (y.iterations, y.halted,
                                               y.scored_per_iter,
                                               y.exchanged_bytes)
                   for x, y in zip(a, b))

    t0 = time.perf_counter()
    cpu = {noise: run("cpu", "allgather", "off", noise)
           for noise in ("replicated", "folded")}
    t_cpu = time.perf_counter() - t0
    n = 0
    t0 = time.perf_counter()
    for plan in ("allgather", "halo", "halo_delta", "delta"):
        for fused in ("on", "off"):
            for noise in ("replicated", "folded"):
                res, d = run("card", plan, fused, noise)
                fast = plan in ("allgather", "delta")
                check(same(res, cpu[noise][0]),
                      f"(j2) {plan}/{fused}/{noise} differs from the CPU run")
                check((d["fast_adapts"], d["fallback_adapts"])
                      == ((2, 0) if fast else (0, 2)),
                      f"(j2) {plan}/{fused}/{noise} counters {d}")
                n += 1
    t_card = time.perf_counter() - t0
    _, d = run("card", "allgather", "off", "replicated", overflow=True)
    check((d["fast_adapts"], d["fallback_adapts"]) == (1, 1),
          f"(j2) overflow batch: {d}")
    try:
        run("card", "allgather", "on", "replicated", backend="cuda")
        check(False, "(j2) the cuda backend's frontier adapt on a mesh ran")
    except ValueError as err:
        check("'torch' score backend" in str(err), f"(j2) {err}")
    print(f"(j2) medium V={v} [{smi}]: {n} mesh sessions (allgather/halo/"
          f"halo_delta/delta x fused on/off x replicated/folded; a frontier "
          f"adapt of 4,000 pairs then a dense one of 16,000, max_iters="
          f"{MESH_MEDIUM_ITERS}) on the card identical to the CPU runs; "
          f"halo and halo_delta fell back; a 600,000-pair batch overflowed "
          f"the slack and fell back; the cuda backend's frontier adapt raised "
          f"ValueError; card {t_card:.3f}s, CPU {t_cpu:.3f}s", flush=True)


def phase_placement(dev, smi: str, report: dict) -> None:
    """(j3) ``expert_placement_case()`` at the reference's defaults on the
    card against the CPU run."""
    from repro_torch.core import placement

    t0 = time.perf_counter()
    g, labels, stats = placement.expert_placement_case(device=dev)
    wall = time.perf_counter() - t0
    _, cpu_labels, cpu_stats = placement.expert_placement_case(device="cpu")
    check(np.array_equal(labels, cpu_labels) and stats == cpu_stats,
          "(j3) expert placement on the card differs from the CPU run")
    print(f"(j3) expert_placement_case() [{smi}]: 256 experts, 20,000 "
          f"tokens, 8 shards, E={g.num_directed_entries}: cross-shard mass "
          f"{stats['cross_before']:.6f} -> {stats['cross_after']:.6f}, rho "
          f"{stats['rho']:.6f}, {stats['iterations']} iterations, "
          f"{wall:.3f}s; identical to the CPU run", flush=True)
    report["placement"] = dict(stats, wall_s=wall)


SERVE_TENANTS, SERVE_N, SERVE_BURST, SERVE_PAIRS = 8, 200_000, 3, 4_000
SERVE_ROUNDS = 3                   # timed rounds after one warm round
POISSON_DURATION, POISSON_RATE = 20.0, 0.25


def _same_result(a, b) -> bool:
    return (np.array_equal(a.labels, b.labels)
            and np.array_equal(a.loads, b.loads)
            and (a.iterations, a.halted) == (b.iterations, b.halted))


def _serve_fleet(graphs, cfg, opts, stream, mode: str) -> dict:
    """One (k1) mode over the request stream: ``naive`` drains after every
    request (one adapt each, no batching); ``serial`` and ``batched``
    queue each round's bursts, then drain (coalescing; batching only in
    ``batched``); ``cuda`` is ``batched``'s scheduler on CUDA-backend
    tenants (serial through K1).  Round 0 warms; the rest are timed."""
    from repro_torch.kernels.spinner_scores import fused_update
    from repro_torch.serve import PartitionScheduler

    n = len(graphs)
    sched = (PartitionScheduler(max_batch=1, batch_min=10 ** 9, policies=())
             if mode == "naive" else PartitionScheduler(
                 max_batch=n, batch_min=10 ** 9 if mode == "serial" else 2,
                 policies=()))
    for i, g in enumerate(graphs):
        sched.add_tenant(f"t{i}", g, cfg, opts, partition=True)
    k1_before = fused_update.launches
    rounds, batched, wall = [], [], 0.0
    for rnd, per_tenant in enumerate(stream):
        if rnd == 1:
            sched.mark()
        before = sched.stats()["batched_dispatches"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tks = []
        for i, bursts in enumerate(per_tenant):
            tks.append([])
            for b in bursts:
                tks[-1].append(sched.submit(f"t{i}", "edge_updates",
                                            edge_updates=b))
                if mode == "naive":
                    sched.drain()
        sched.drain()
        torch.cuda.synchronize()
        if rnd:
            wall += time.perf_counter() - t0
        batched.append(sched.stats()["batched_dispatches"] - before)
        rounds.append(tks)
    st = sched.stats()
    check(st["errors"] == 0 and st["queued"] == 0,
          f"(k1) {mode}: {st['errors']} errors, {st['queued']} queued")
    d = [t.session.stats()["delta"] for t in sched.tenants.values()]
    iters = sum(tk.result.iterations for tks in rounds for row in tks
                for tk in (row if mode == "naive" else row[-1:]))
    return dict(rounds=rounds, batched=batched, stats=st, wall_s=wall,
                requests=n * SERVE_BURST * (len(stream) - 1),
                host_rebuilds=sum(x["host_rebuilds"] for x in d),
                fallback_adapts=sum(x["fallback_adapts"] for x in d),
                k1_launches=fused_update.launches - k1_before,
                iterations=iters,
                sessions=[t.session for t in sched.tenants.values()])


def _serve_split(sessions, cfg, dev, smi: str) -> dict:
    """One batched iteration of the torch fleet split into draws / scores
    / epilogue, beside the same 8 tenants' serial iterations; from warm
    work items (each session's next adapt, with its delta segment)."""
    from repro_torch.core import delta, engine
    from repro_torch.serve import traffic

    gen = np.random.default_rng(99)
    items, host = [], {"adapt_parts_ms": 0.0, "commit_ms": 0.0}
    for s in sessions:
        batch = delta.coalesce_updates([traffic.random_edge_updates(
            s.stats()["num_vertices"], SERVE_PAIRS, gen)
            for _ in range(SERVE_BURST)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, b, c, o = s.adapt_parts(edge_updates=batch)
        torch.cuda.synchronize()
        host["adapt_parts_ms"] += (time.perf_counter() - t0) * 1e3
        items.append((st, b, o))
    opts = items[0][2]
    state = engine.stack_states([st for st, _, _ in items])
    bind = engine.stack_binds([b for _, b, _ in items])
    keys = engine.chunk_keys([st.key for st, _, _ in items],
                             range(len(items)), 1, dev)[0]
    v_pad = state.labels.shape[1]
    noise, u = engine.batched_draws(cfg, keys, v_pad)
    scores = engine.batched_scores(state.labels, bind, cfg.k)
    split = {
        "draws_ms": time_ms(lambda: engine.batched_draws(cfg, keys, v_pad),
                            reps=3, warmup=1),
        "scores_ms": time_ms(lambda: engine.batched_scores(
            state.labels, bind, cfg.k), reps=3, warmup=1),
        "epilogue_ms": time_ms(lambda: engine.batched_update(
            cfg, scores, state.labels, state.loads, noise, u, bind),
            reps=3, warmup=1),
        "step_ms": time_ms(lambda: engine._batched_step(cfg, state, keys,
                                                         bind),
                           reps=3, warmup=1),
    }
    del noise, u, scores
    from repro_torch import rng
    scores_fn = opts.backend().make_scores(cfg.k)
    update = engine.make_vertex_update(cfg)
    step = engine.make_step(cfg, opts)
    serial = dict.fromkeys(("draws_ms", "scores_ms", "epilogue_ms",
                            "step_ms"), 0.0)
    for st, b, _ in items:
        kn, km = rng.split(rng.split(st.key)[1])

        def draws():
            return (rng.uniform(kn, (v_pad, cfg.k), 0.0, cfg.tie_noise,
                                device=dev),
                    rng.uniform(km, (v_pad,), device=dev))

        nz, uu = draws()
        sc = scores_fn(st.labels, *b.score)
        serial["draws_ms"] += time_ms(draws, reps=3, warmup=1)
        serial["scores_ms"] += time_ms(lambda: scores_fn(st.labels,
                                                         *b.score),
                                       reps=3, warmup=1)
        serial["epilogue_ms"] += time_ms(lambda: update(
            sc, st.labels, b.deg_w, st.loads, nz, uu, b.valid, b.capacity),
            reps=3, warmup=1)
        serial["step_ms"] += time_ms(lambda: step(st, b), reps=3, warmup=1)
        del nz, uu, sc
    for s, (st, _, _) in zip(sessions, items):
        t0 = time.perf_counter()
        s.commit_adapt(st)            # the read-back a window's commit does
        host["commit_ms"] += (time.perf_counter() - t0) * 1e3
    host = {k: x / len(items) for k, x in host.items()}
    print(f"(k1) one batched iteration of {len(items)} tenants [{smi}]: "
          + " ".join(f"{k}={x:.3f}" for k, x in split.items())
          + f"; the same {len(items)} tenants' serial iterations: "
          + " ".join(f"{k}={x:.3f}" for k, x in serial.items())
          + "; host work a window (mean, a coalesced burst): "
          + " ".join(f"{k}={x:.3f}" for k, x in host.items()), flush=True)
    return dict(batched=split, serial=serial, host_per_window=host)


def phase_serve_fleet(dev, smi: str, report: dict) -> list:
    """(k1) Eight same-bucket tenants of ~200,000 vertices: naive serving,
    the scheduler serial and batched on the torch backend, and the
    scheduler on the CUDA backend (serial, K1), on one request stream;
    every ticket held to a twin session; returns the graphs."""
    from repro_torch.core import (EngineOptions, SpinnerConfig, delta,
                                  engine, open_session)
    from repro_torch.serve import traffic

    t0 = time.perf_counter()
    graphs = [traffic.tenant_graph(SERVE_N + 17 * i, seed=i, k_nbrs=16)
              for i in range(SERVE_TENANTS)]
    t_build = time.perf_counter() - t0
    buckets = {engine.graph_buckets(g) for g in graphs}
    check(len(buckets) == 1, f"(k1) tenants in {len(buckets)} buckets")
    cfg = SpinnerConfig(k=K)
    gen = np.random.default_rng(7)
    stream = [[[traffic.random_edge_updates(g.num_vertices, SERVE_PAIRS,
                                            gen)
                for _ in range(SERVE_BURST)] for g in graphs]
              for _ in range(1 + SERVE_ROUNDS)]
    torch_opts = EngineOptions(device=dev, score_backend="torch")
    runs = {}
    for mode, opts in (("naive", torch_opts), ("serial", torch_opts),
                       ("batched", torch_opts),
                       ("cuda", EngineOptions(device=dev,
                                              score_backend="cuda"))):
        runs[mode] = _serve_fleet(graphs, cfg, opts, stream, mode)
        if mode != "batched":          # only the split reads them again
            del runs[mode]["sessions"]

    # the twins: a session that adapts once per coalesced window, and one
    # that adapts once per request
    for i, g in enumerate(graphs):
        win, one = (open_session(g, cfg, torch_opts) for _ in range(2))
        win.partition(record_history=False)
        one.partition(record_history=False)
        for rnd, per_tenant in enumerate(stream):
            want = win.adapt(edge_updates=delta.coalesce_updates(
                per_tenant[i]), record_history=False)
            for mode in ("serial", "batched", "cuda"):
                tks = runs[mode]["rounds"][rnd][i]
                check(all(tk.result is tks[-1].result for tk in tks)
                      and _same_result(tks[-1].result, want),
                      f"(k1) {mode} tenant {i} round {rnd} differs from "
                      "its twin's coalesced adapt")
            for j, b in enumerate(per_tenant[i]):
                check(_same_result(runs["naive"]["rounds"][rnd][i][j].result,
                                   one.adapt(edge_updates=b,
                                             record_history=False)),
                      f"(k1) naive tenant {i} round {rnd} request {j} "
                      "differs from its twin's adapt")
    for mode, r in runs.items():
        st = r["stats"]
        check(st["uploads_since_mark"] == 0 and r["host_rebuilds"] == 0
              and r["fallback_adapts"] == 0,
              f"(k1) {mode}: {st['uploads_since_mark']} uploads since the "
              f"mark, {r['host_rebuilds']} host rebuilds, "
              f"{r['fallback_adapts']} fallbacks")
        want_batched = [1] * len(stream) if mode == "batched" else \
            [0] * len(stream)
        check(r["batched"] == want_batched,
              f"(k1) {mode}: batched runs per round {r['batched']}")
    check(runs["cuda"]["k1_launches"] == runs["cuda"]["iterations"],
          f"(k1) K1 launched {runs['cuda']['k1_launches']} times in "
          f"{runs['cuda']['iterations']} iterations")
    for mode in ("naive", "serial", "batched"):
        check(runs[mode]["k1_launches"] == 0,
              f"(k1) {mode} launched K1 on the torch backend")
    v_pad, e_pad = buckets.pop()
    out = {}
    for mode, r in runs.items():
        st = r["stats"]
        rps = r["requests"] / r["wall_s"]
        out[mode] = dict(throughput_rps=rps, wall_s=r["wall_s"],
                         requests=r["requests"],
                         coalescing_factor=st["coalescing_factor"],
                         batch_occupancy=st["batch_occupancy"],
                         batched_dispatches=st["batched_dispatches"],
                         serial_dispatches=st["serial_dispatches"],
                         iterations=r["iterations"],
                         k1_launches=r["k1_launches"],
                         uploads_since_mark=st["uploads_since_mark"])
        print(f"(k1) {mode} [{smi}]: {r['requests']} requests in "
              f"{r['wall_s']:.3f}s = {rps:.3f} requests/s; coalescing "
              f"factor {st['coalescing_factor']:.3f}, batch occupancy "
              f"{st['batch_occupancy']:.3f}, batched/serial dispatches "
              f"{st['batched_dispatches']}/{st['serial_dispatches']}, "
              f"{r['iterations']} iterations, K1 launches "
              f"{r['k1_launches']}, uploads since the mark "
              f"{st['uploads_since_mark']}", flush=True)
    ratio = out["batched"]["throughput_rps"] / out["serial"]["throughput_rps"]
    coal = out["serial"]["throughput_rps"] / out["naive"]["throughput_rps"]
    print(f"(k1) {SERVE_TENANTS} tenants V={[g.num_vertices for g in graphs]}"
          f" in bucket ({v_pad}, {e_pad}), built in {t_build:.3f}s; bursts "
          f"of {SERVE_BURST} x {SERVE_PAIRS} pairs, 1 warm + {SERVE_ROUNDS} "
          f"timed rounds; every ticket identical to its twin session "
          f"(coalesced window / one adapt per request); the CUDA backend "
          f"identical to the torch backend with K1 once an iteration; "
          f"serial/naive throughput {coal:.3f}, batched/serial {ratio:.3f} "
          f"[{smi}]", flush=True)
    split = _serve_split(runs["batched"]["sessions"], cfg, dev, smi)
    report["serve_fleet"] = dict(
        out, batched_over_serial=ratio, serial_over_naive=coal,
        bucket=[v_pad, e_pad], build_s=t_build, split=split, card=smi)
    return graphs


def phase_serve_poisson(dev, smi: str, report: dict) -> None:
    """(k2) An open-loop Poisson replay over a power-law fleet of 16
    CUDA-backend tenants with the default policies: zero errors, every
    queue drained within twice the trace's duration."""
    from repro_torch.core import EngineOptions, SpinnerConfig
    from repro_torch.kernels.spinner_scores import fused_update
    from repro_torch.serve import PartitionScheduler, traffic

    sizes = traffic.powerlaw_sizes(16, v_min=16_384, v_max=1_048_576,
                                   alpha=2.2, seed=0)
    names = {f"p{i:02d}": v for i, v in enumerate(sizes)}
    cfg = SpinnerConfig(k=K)
    opts = EngineOptions(device=dev, score_backend="cuda")
    sched = PartitionScheduler()
    t0 = time.perf_counter()
    for i, (name, v) in enumerate(sorted(names.items())):
        sched.add_tenant(name, traffic.tenant_graph(v, seed=i), cfg, opts,
                         partition=True)
    t_admit = time.perf_counter() - t0
    events = traffic.poisson_trace(
        names, duration=POISSON_DURATION, rate=POISSON_RATE, burst_mean=3,
        mix=(0.8, 0.15, 0.05), edges_per_update=1_000,
        k_choices=(16, 32, 64), seed=0)
    k1 = fused_update.launches
    t0 = time.perf_counter()
    done = traffic.replay(sched, events)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = sched.stats()
    check(st["errors"] == 0 and st["queued"] == 0 and done == len(events),
          f"(k2) {st['errors']} errors, {st['queued']} queued, {done} of "
          f"{len(events)} completed")
    check(wall <= 2 * POISSON_DURATION,
          f"(k2) the trace took {wall:.3f}s, over twice its duration")
    kinds = {k: sum(e.kind == k for e in events)
             for k in ("edge_updates", "adapt", "resize")}
    lat, lat_a = st["latency"], st["adapt_latency"]
    print(f"(k2) Poisson replay [{smi}]: {len(names)} tenants "
          f"V={sorted(sizes)} "
          f"admitted in {t_admit:.3f}s; {len(events)} requests {kinds} over "
          f"{POISSON_DURATION:.0f}s at rate {POISSON_RATE}/s a tenant, "
          f"drained in {wall:.3f}s; latency p50 {lat['p50'] * 1e3:.3f} ms "
          f"p99 {lat['p99'] * 1e3:.3f} ms, adapts p50 "
          f"{lat_a['p50'] * 1e3:.3f} ms p99 {lat_a['p99'] * 1e3:.3f} ms; "
          f"throughput {st['throughput_rps']:.3f} requests/s; coalescing "
          f"factor {st['coalescing_factor']:.3f}; dispatches batched/serial "
          f"{st['batched_dispatches']}/{st['serial_dispatches']}; policies "
          f"{st['policies']}; errors {st['errors']}; K1 launches "
          f"{fused_update.launches - k1}", flush=True)
    report["serve_poisson"] = dict(
        requests=len(events), kinds=kinds, wall_s=wall, rate=POISSON_RATE,
        latency=lat, adapt_latency=lat_a,
        throughput_rps=st["throughput_rps"],
        coalescing_factor=st["coalescing_factor"],
        batched_dispatches=st["batched_dispatches"],
        serial_dispatches=st["serial_dispatches"],
        policies=st["policies"], k1_launches=fused_update.launches - k1,
        card=smi)


def phase_serve_durability(graphs, dev, smi: str, report: dict) -> None:
    """(k3) One (k1) tenant on the CUDA backend: export_state, save,
    restore, import_state into a freshly opened session; its next adapt
    identical to the uninterrupted session's."""
    import tempfile

    from repro_torch.ckpt import checkpoint
    from repro_torch.core import (EngineOptions, SpinnerConfig, add_edges,
                                  open_session)
    from repro_torch.serve import traffic

    g, cfg = graphs[0], SpinnerConfig(k=K)
    opts = EngineOptions(device=dev, score_backend="cuda")
    gen = np.random.default_rng(13)
    b1, b2 = (traffic.random_edge_updates(g.num_vertices, SERVE_PAIRS, gen)
              for _ in range(2))
    live = open_session(g, cfg, opts)
    live.partition(record_history=False)
    live.adapt(edge_updates=b1, record_history=False)
    snap = live.export_state()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        checkpoint.save(tmp, 1, snap)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = checkpoint.restore(tmp, snap)
        t_restore = time.perf_counter() - t0
    want = live.adapt(edge_updates=b2, record_history=False)
    fresh = open_session(add_edges(g, *b1), cfg, opts).import_state(restored)
    got = fresh.adapt(edge_updates=b2, record_history=False)
    check(_same_result(got, want), "(k3) the restored session's adapt "
          "differs from the uninterrupted session's")
    print(f"(k3) tenant 0 (V={g.num_vertices}) [{smi}]: export_state, save "
          f"{t_save * 1e3:.3f} ms, restore {t_restore * 1e3:.3f} ms, "
          f"import_state; the next adapt ({want.iterations} iterations) "
          f"identical to the uninterrupted session's", flush=True)
    report["serve_durability"] = dict(save_ms=t_save * 1e3,
                                      restore_ms=t_restore * 1e3,
                                      iterations=want.iterations)


def print_rates(kernels: list) -> None:
    """(e) Each kernel's achieved rate, the bytes its bound counts over its
    measured time, beside the bound; adds ``achieved_bytes_per_s`` (and
    ``_min`` for the combine kernels' min forms) to each entry."""
    for r in kernels:
        for sfx in ("", "_min"):
            if "ms" + sfx not in r or "bytes" + sfx not in r:
                continue
            ms, nbytes = r["ms" + sfx], r["bytes" + sfx]
            rate = nbytes / (ms * 1e-3)
            r["achieved_bytes_per_s" + sfx] = rate
            print(f"(e) {r['name']}{sfx}: {ms:.3f} ms for {nbytes} B = "
                  f"{rate / 1e12:.3f} TB/s achieved, bound "
                  f"{r['bound_ms' + sfx]:.3f} ms at "
                  f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s "
                  f"({r['bound_ms' + sfx] / ms:.3f} of it)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.distributed as dist
    from repro_torch.core import engine, generators
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    print(f"(a) python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; card: {smi}", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    per_source = ", ".join(f"{n} {s:.3f}s" for n, (s, _) in built.items())
    print(f"(a) kernel build {time.perf_counter() - t0:.3f}s wall "
          f"(nvcc per source: {per_source or 'cached'})", flush=True)
    for name, (_, log) in built.items():
        print(f"(a) {name} ptxas: " + " | ".join(
            ln.strip() for ln in log.splitlines() if "registers" in ln
            or "spill" in ln), flush=True)

    t0 = time.perf_counter()
    graph = generators.watts_strogatz(FULL_N, DEG, BETA, seed=0)
    padded, _ = engine.padded_view(graph, engine.EngineOptions(device=dev))
    print(f"(a) host graph build {time.perf_counter() - t0:.3f}s: "
          f"V={graph.num_vertices} E={graph.num_directed_entries} padded "
          f"to ({padded.num_vertices}, {padded.num_directed_entries}); "
          f"total weight {graph.total_weight:.0f} exceeds 2^24, per-partition "
          f"loads and M(l) stay below it", flush=True)

    report: dict = {}
    phase_kernels(padded, dev, report)
    torch.cuda.empty_cache()
    labels = phase_main_path(graph, padded, dev, report)
    torch.cuda.empty_cache()
    medium = phase_medium_parity(dev, report)
    phase_halved_weights(medium[0], dev)
    torch.cuda.empty_cache()
    phase_apps(graph, labels, dev, report)
    phase_apps_medium(*medium, dev)
    torch.cuda.empty_cache()
    phase_frontier_kernel(graph, padded, labels, dev, report)
    torch.cuda.empty_cache()
    phase_session(graph, dev, report)
    phase_session_medium(medium[0], dev)
    torch.cuda.empty_cache()
    phase_sharded_kernels(padded, graph.num_vertices, labels, dev, report)
    torch.cuda.empty_cache()
    phase_sharded_main(graph, report["main_result"], dev, report)
    phase_sharded_medium(*medium, dev, report)
    torch.cuda.empty_cache()
    phase_apps_mesh_kernels(graph, labels, dev, report)
    torch.cuda.empty_cache()
    phase_apps_mesh_main(graph, labels, dev, report)
    phase_apps_mesh_medium(*medium, dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_mesh_session(graph, dev, smi, report)
    torch.cuda.empty_cache()
    phase_mesh_medium(*medium, dev, smi)
    phase_placement(dev, smi, report)
    print(f"(j) phase (j) took {time.perf_counter() - t0:.3f}s [{smi}]",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_graphs = phase_serve_fleet(dev, smi, report)
    torch.cuda.empty_cache()
    phase_serve_poisson(dev, smi, report)
    phase_serve_durability(serve_graphs, dev, smi, report)
    print(f"(k) phase (k) took {time.perf_counter() - t0:.3f}s [{smi}]",
          flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)

    tpu = "src/repro/kernels/spinner_scores.py"
    replaces = {"fused_update_csr": f"{tpu}:241",
                "spinner_scores_csr": f"{tpu}:100"}
    kernels = [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": replaces[name], "launches": r["launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": r["library_ms"],
        "ms_random_labels": r["random_labels"]["ms"],
        "plain_ms_random_labels": r["random_labels"]["plain_ms"],
        "library_ms_random_labels": r["random_labels"]["library_ms"],
    } for name, r in ((n, report[n]) for n in replaces)]
    kernels += [{"name": name, "route": "cuda", "source": PREGEL_SOURCE,
                 "replaces": f"{PREGEL_TPU}:{line}", **report[name]}
                for name, line in (("pregel_reduce_csr", 132),
                                   ("pregel_combine_csr", 175))]
    front = report["fused_update_frontier_csr"]
    kernels.append({
        "name": "fused_update_frontier_csr", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": f"{tpu}:241",
        "variant": "tile_act (has_act=True)", "launches": front["launches"],
        "max_abs_err": max(front["max_abs_err"],
                           front["random10"]["max_abs_err"]),
        "ms": front["ms"], "plain_ms": front["plain_ms"],
        "bound_ms": front["bound_ms"], "bound_by": front["bound_by"],
        "library_ms": None, "bytes": front["bytes"],
        "active_fraction": front["active_fraction"],
        "ms_random10": front["random10"]["ms"],
        "plain_ms_random10": front["random10"]["plain_ms"],
        "bound_ms_random10": front["random10"]["bound_ms"],
        "base_form_ms_same_labels": front["base_form_ms"]})
    seeded, shards = report["fused_update_seeded_csr"], \
        report["sharded_shards"]
    kernels.append({
        "name": "fused_update_seeded_csr", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": f"{tpu}:241",
        "variant": "acc_init (has_init=True)", "launches": seeded["launches"],
        "max_abs_err": max(seeded["max_abs_err"],
                           report["seeded_shard_err"]),
        "ms": seeded["ms"], "plain_ms": seeded["plain_ms"],
        "bound_ms": seeded["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "bytes": seeded["bytes"],
        "ms_4_shards": [r["seeded_ms"] for r in shards],
        "plain_ms_4_shards": [r["plain_seeded_ms"] for r in shards],
        "bound_ms_4_shards": [r["seeded_bound_ms"] for r in shards],
        "frontier_edges_4_shards": [r["frontier_edges"] for r in shards],
        "base_ms_4_shards": [r["base_ms"] for r in shards]})
    for r in kernels:
        if r["name"] in ("spinner_scores_csr", "fused_update_csr"):
            r["bytes"] = report[r["name"]]["bytes"]
        if r["name"] == "fused_update_csr":
            # (k): the CUDA-backend fleet's serial K1 path, and the replay
            r["launches_serve_fleet"] = report["serve_fleet"]["cuda"][
                "k1_launches"]
            r["launches_serve_poisson"] = report["serve_poisson"][
                "k1_launches"]
        if r["name"] in ("pregel_reduce_csr", "pregel_combine_csr"):
            # (i): K3 over each rank's interior, K4 over its frontier
            part = "k3" if r["name"] == "pregel_reduce_csr" else "k4"
            r["launches_mesh_world_1"] = report["apps_mesh_main"]["launches"]
            r["max_abs_err"] = max(r["max_abs_err"],
                                   report["apps_mesh_err"][r["name"]])
            for place, res in report["apps_mesh_shards"].items():
                for sfx in ("", "_min"):
                    for key in ("ms", "bound_ms", "plain_ms"):
                        r[f"{key}_4_shards_{place}{sfx}"] = [
                            sh[f"{part}_{key}{sfx}"] for sh in res["shards"]]
    print_rates(kernels)
    k2 = next(r for r in kernels if r["name"] == "spinner_scores_csr")
    k2.update(interior_ms_4_shards=[r["interior_ms"] for r in shards],
              interior_bound_ms_4_shards=[r["interior_bound_ms"]
                                          for r in shards],
              interior_ms_world_1=report["sharded_main"]["split"][
                  "interior_ms"],
              launches_overlap=report["sharded_main"]["on"][
                  "interior_launches"])
    print(json.dumps({"kernels": kernels}))
    if dist.is_initialized():
        dist.destroy_process_group()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
