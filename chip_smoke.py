"""Smoke run of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --autotune-only     # phase (p) alone

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
      SpinnerConfig(k=32, max_iters=60))`` (the frontier adapt runs to
      ``max_iters``; cut from 300 for the time limit) running
      ``partition()``, ``adapt(edge_updates=B1, frontier=True)`` (64,000
      pairs, 0.1% of the edges) and
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
      mesh (torch backend, overlap off, the allgather plan, max_iters 40 as
      (g2)) running
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
  (l) the cluster runtime (``repro_torch.cluster``): (l1) the full graph's
      edge shards for two hosts, two worker processes on the card under
      ``ProcessClusterSupervisor`` (the store hosted by the supervisor),
      worker 1 killed at superstep 6 of 12, the one-process generation
      resuming from the snapshot of superstep 4: its labels identical to
      an uninterrupted one-process job's, phi equal, every worker's K2
      launched once a superstep, one superstep's split per worker (draws /
      K2 / propose-finish / store exchange / heartbeat), and K2 on one
      worker's rows bitwise equal to its plain version, timed with its
      bound; (l2) ``PartitionSupervisor`` on the CUDA backend (K1):
      ``partition`` + 3 ``adapt`` on the full graph clean, with
      ``kill_worker_at(2)`` and with the newest snapshot torn first --
      identical labels, the recover seconds -- and on the medium graph a
      kill after two edge batches replaying them; (l3) (k1)'s tenants on
      the CUDA backend under ``PartitionScheduler(deployment=
      ClusterDeployment(...))``, one poisoned dispatch recovered and
      retried, every ticket identical to its twin session's;
  (m) the LLM scaffolding (``repro_torch.{configs,models,optim,data,
      train}``, no kernel of its own): (m1) ``python -m
      repro_torch.launch.serve_llm`` serving stablelm-1.6b at full width and
      depth (8 prompts of 1024 tokens, 64 generated), its first 4 decode
      steps held to one forward over the same tokens (atol 0.1, rtol
      0.05), with prefill seconds, decode ms/step, tokens/s, peak memory
      and the decode step's byte bound; (m2) ``python -m
      repro_torch.launch.train``, 4 full-width steps of 4 x 4096 tokens
      (remat on): finite losses and grad norms, ms/step and tokens/s
      beside the bf16 FLOP bound, peak memory, the final checkpoint's size
      and save seconds (deleted after); (m3) qwen3-moe-235b-a22b at full
      width cut to 2 layers: a prefill of 4 x 512, 16 decode steps, one
      loss_fn forward + backward, the "sort" and "cumsum" dispatches'
      losses within rel 2e-2; (m4) the card against the port's CPU at
      reduced() stablelm-1.6b and qwen3-moe (losses rtol 1e-3, logits atol
      5e-2), the flash attention's grads, and a 2 + 2-step training run
      restored from its checkpoint bit-identical to 4 uninterrupted steps;
      (m5) one full-width train step split into forward / backward / AdamW
      and one decode step, each profiled (device busy time, idle share,
      kernels by kind);
  (n) the rwkv, hybrid, encdec and vlm families (no kernel of their own:
      their chunk scans are torch operations, as the reference's are jnp):
      (n1) ``serve_llm`` serving rwkv6-1.6b, zamba2-7b,
      seamless-m4t-large-v2 and llama-3.2-vision-11b at full width and
      depth, one child process each (8 prompts of 1024 tokens, 20
      generated, the first 16 decode steps held to one forward), with
      each family's decode byte bound; (n2) ``python -m
      repro_torch.launch.train`` on seamless-m4t-large-v2 (the
      ``src_embed`` frontend stub), 3 full-width steps of 4 x 1024 tokens,
      its 24.4 GB checkpoint saved, sized and deleted; (n3) one
      ``loss_fn`` forward + backward at full width on 2 x 2048 tokens:
      rwkv6-1.6b at full depth, zamba2-7b cut to 15 layers and
      llama-3.2-vision-11b cut to 10 (float32 params and grads), each
      beside its bf16 FLOP bound; (n4) the four reduced configs on the
      card against the port's CPU (loss rtol 1e-3; prefill, 4 decode
      steps and the final state or cache atol 5e-2); (n5) a full-width
      rwkv6-1.6b forward + backward (2 layers) and a zamba2-7b decode step
      profiled (device busy time by kind, idle share); (n1b) zamba2-7b's
      decode held to its forward block by block at full width and depth
      (each Mamba2 block and shared-block application on the forward's
      own input): its logits cannot be, bf16 rounding differences grow
      ~1.2-1.5x a Mamba2 block at this init, the reference's too;
  (o) the 2-D meshes (``repro_torch.parallel``, no kernel of their own):
      (o1) in a child process, 2 plain ``steps.make_train_step`` steps of
      stablelm-1.6b on plain tensors at (m2)'s cut and seed, their losses
      and grad norms held bit for bit to (m2)'s launcher run, which
      placed its state on a one-rank ``("data", "model")`` mesh through the
      sharding rules: ms/step and peak bytes of both; (o2) ``python -m
      repro_torch.launch.dryrun --mesh single --shape train_4k`` for
      stablelm-1.6b and for qwen3-moe-235b-a22b at its full 94 layers (a
      depth one card cannot hold), as rank 0 of a fake process group of
      256 on the (16, 16) production mesh with fake tensors on the card's
      device (nothing allocated; started with phase (a), CPU work):
      per-device bytes, dot FLOPs and collective bytes, the per-device
      bytes x 256 at least the params, grads and AdamW moments;
  (p) the tile autotuner (``repro_torch.kernels.autotune``): on the full
      graph at k = 32, the medium graph at k = 2, 8, 32, 128 and 512, and
      a skewed graph (Chung-Lu with Zipf expected degrees, exponent 2.1,
      1,048,576 vertices, expected average degree 16, built -- with
      (k1)'s tenant graphs -- by a child process started in phase (a)),
      K1's
      base form and K2 under every candidate tile and the default, each
      bitwise equal to one plain run of its case, with its CUDA-event
      median time, the model's cost and grid beside the time and the
      card's grid; the model's pick against the measured best and their
      ratio; a least-squares fit of the model's constants on this run;
      then ``partition()`` of the medium graph with ``autotune="on"``,
      ``"off"`` and a pinned non-default tile: identical labels, loads
      and iterations, with ``stats()["tile_config"]``;
  (e) each kernel's achieved bytes/s (the bytes its bound counts over its
      measured time) beside its bound, then one JSON line describing each
      kernel (K1's and K2's with the tile the main path launched).

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
# (g2) / (j1) depth: the full graph's frontier adapt never drains (a Spinner
# halt is a score stall, not a fixed point), so it runs to max_iters; cut
# from the default 300 to keep the smoke, phases (n) and (o) included,
# inside its time limit
SESSION_ITERS = 40
# (p): the skewed graph's shape and the medium graph's k sweep
SKEW_N, SKEW_DEG, SKEW_EXP = 1_048_576, 16, 2.1
TUNE_KS = (2, 8, 32, 128, 512)
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
                          num_real: int, tiles: dict) -> dict:
    """Both kernels on these inputs against their plain versions: bitwise
    equal, with CUDA-event median times of the kernel, the plain version
    and, for the score matrix, ``torch.sparse.mm`` (a library yardstick
    the port never calls).  ``tiles`` holds each kernel's tile, the one
    the main path launches (``main_tiles``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.spinner_scores import fused_update, spinner_scores

    csr = padded.to_device(dev)
    v = padded.num_vertices
    src = csr.src

    def k2():
        return spinner_scores(labels, csr.row_ptr, csr.dst, csr.weight, K,
                              tile=tiles["scores"])

    def k2_plain():
        return ref.spinner_scores_ref(labels, src, csr.dst, csr.weight, v, K)

    def k1(weighted=True):
        return fused_update(labels, csr.row_ptr, csr.dst, csr.weight,
                            csr.deg_w, pen, noise, num_real, K, 1e-6,
                            weighted, tile=tiles["fused"])

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


def main_tiles(graph, dev) -> dict:
    """The tile the main path's K1 (``partition``) and its split path's K2
    (``fused_update="off"``) launch with, as the autotuner binds it."""
    from repro_torch.core import EngineOptions, SpinnerConfig, engine

    cfg = SpinnerConfig(k=K)
    out = {}
    for form, fused in (("fused", "auto"), ("scores", "off")):
        opts = engine._autotuned(graph, cfg, EngineOptions(
            device=dev, fused_update=fused))
        out[form] = opts.backend().tile(K, form)
    return out


def phase_kernels(graph, padded, dev, report: dict) -> None:
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
    tiles = report["main_tiles"] = main_tiles(graph, dev)
    print(f"(b) the main path's tiles (warps, rows), the autotuner's: K1 "
          f"{tiles['fused']}, K2 {tiles['scores']} (None: the default)",
          flush=True)
    res = kernels_against_plain(padded, dev, labels, pen, noise, v - 1000,
                                tiles)
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
    draws_kernel(v, dev, report)


def phase_main_path(graph, padded, dev, report: dict) -> np.ndarray:
    """(c) The main path at full size, through the fused kernel; returns
    the labels it converged to."""
    from repro_torch import rng
    from repro_torch.core import EngineOptions, SpinnerConfig, metrics
    from repro_torch.core import engine, partition
    from repro_torch.kernels.spinner_scores import fused_update, spinner_scores
    from repro_torch.kernels.threefry import uniform_threefry

    cfg = SpinnerConfig(k=K)
    opts = EngineOptions(device=dev)
    fused_update.launches = spinner_scores.launches = 0
    uniform_threefry.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = partition(graph, cfg, engine="fused", options=opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_launches, k2_launches = fused_update.launches, spinner_scores.launches
    report["fused_update_csr"]["tile"] = list(fused_update.last_tile)
    check(k1_launches == res.iterations,
          f"fused_update_csr launched {k1_launches} times in "
          f"{res.iterations} iterations")
    check(k2_launches == 0, "split score kernel ran on the fused path")
    report["fused_update_csr"]["launches"] = k1_launches
    draws = report["threefry_uniform"]["launches"] = uniform_threefry.launches
    check(draws == 2 * res.iterations,
          f"threefry_uniform launched {draws} times in {res.iterations} "
          f"iterations (two draws an iteration)")

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
          f"fused_update_csr launches={k1_launches} threefry_uniform "
          f"launches={draws}", flush=True)
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
                                      bind.num_real, report["main_tiles"])
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
    # the draws on these keys, held to the plain path and timed (the times
    # the kernels line reports)
    drawn = draws_against_plain(k_noise, k_mig, v_pad, cfg.tie_noise, dev)
    print_draws("c, the main path's keys", drawn)
    report["threefry_uniform"].update(drawn)
    split = {
        "rng_ms": drawn["ms"],
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
    report["spinner_scores_csr"]["tile"] = list(spinner_scores.last_tile)
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


# The threefry kernel's bound: threefry2x32 needs 20 rotates and 20 xors
# an output on the integer ALU pipe, 64 lanes an SM; its adds can all
# issue as IMAD on the FMA pipe.  The bound is the function's, not this
# build's: nvcc's loop issues 55.5 ALU-pipe instructions an output (80 in
# all, by cuobjdump -sass), adds left on IADD3 and address arithmetic.
THREEFRY_SOURCE = "src/repro_torch/kernels/csrc/threefry.cu"
THREEFRY_ALU_PER_OUTPUT = 40
ALU_LANES_PER_SM = 64


def draws_against_plain(k_noise, k_mig, v: int, tie: float, dev) -> dict:
    """One iteration's draws, the ``(v, K)`` tie noise in [0, tie) and the
    ``(v,)`` migration draws, through ``rng.uniform`` (the threefry kernel,
    a launch each) against ``rng._uniform_plain`` on the same keys --
    bitwise equal -- with CUDA-event median times of both."""
    from repro_torch import rng
    from repro_torch.kernels.threefry import uniform_threefry

    def noise(draw=rng.uniform):
        return draw(k_noise, (v, K), 0.0, tie, device=dev)

    def u(draw=rng.uniform):
        return draw(k_mig, (v,), device=dev)

    n0 = uniform_threefry.launches
    got = (noise(), u())
    check(uniform_threefry.launches == n0 + 2,
          "an iteration's draws are not two threefry launches")
    want = (noise(rng._uniform_plain), u(rng._uniform_plain))
    torch.cuda.synchronize()
    for name, a, b in zip(("noise", "u"), got, want):
        check(bits_equal(a, b), f"threefry_uniform {name} != "
              f"rng._uniform_plain")
    err = max_abs_err(zip(got, want))
    del got, want
    return dict(
        max_abs_err=err, ms=time_ms(lambda: (noise(), u()), reps=20),
        noise_ms=time_ms(noise, reps=20), u_ms=time_ms(u, reps=20),
        plain_ms=time_ms(lambda: (noise(rng._uniform_plain),
                                  u(rng._uniform_plain)), reps=5))


def print_draws(tag: str, r: dict) -> None:
    print(f"({tag}) threefry_uniform: bitwise equal (max_abs_err "
          f"{r['max_abs_err']}), {r['ms']:.4f} ms for an iteration's two "
          f"draws (noise {r['noise_ms']:.4f}, u {r['u_ms']:.4f}; plain "
          f"{r['plain_ms']:.3f} ms)", flush=True)


def draws_kernel(v: int, dev, report: dict) -> None:
    """(b) The threefry kernel at the main path's shapes: an iteration's
    draws on fresh keys and ``engine.batched_draws`` of two elements
    (``uniform_many`` over the strided ``keys[:, 0]`` and ``keys[:, 1]``
    views) against the plain path; its bounds by ALU instructions and by
    bytes."""
    from repro_torch import rng
    from repro_torch.core import SpinnerConfig, engine
    from repro_torch.kernels.threefry import uniform_threefry

    cfg = SpinnerConfig(k=K)
    drawn = draws_against_plain(*rng.split(rng.PRNGKey(13)), v,
                                cfg.tie_noise, dev)
    print_draws("b", drawn)
    keys = [rng.split(rng.PRNGKey(14 + b)) for b in range(2)]
    n0 = uniform_threefry.launches
    noise, u = engine.batched_draws(
        cfg, torch.tensor(keys, dtype=torch.int64, device=dev), v)
    check(uniform_threefry.launches == n0 + 2,
          "batched draws are not two threefry launches")
    for b, (k_noise, k_mig) in enumerate(keys):
        check(bits_equal(noise[b], rng._uniform_plain(
            k_noise, (v, K), 0.0, cfg.tie_noise, device=dev))
            and bits_equal(u[b], rng._uniform_plain(k_mig, (v,),
                                                    device=dev)),
            f"batched draws of element {b} != rng._uniform_plain")
    del noise, u

    outputs = v * (K + 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    alu = outputs * THREEFRY_ALU_PER_OUTPUT
    report["threefry_uniform"] = dict(
        random_keys=drawn, outputs=outputs, alu_instructions=alu, sms=sms,
        clock_max_mhz=mhz,
        bound_ms=alu / (sms * ALU_LANES_PER_SM * mhz * 1e6) * 1e3,
        bytes=4 * outputs, bound_bytes_ms=4 * outputs / HBM_BYTES_PER_S * 1e3)
    r = report["threefry_uniform"]
    print(f"(b) threefry_uniform: batched draws of 2 keys (strided views) "
          f"bitwise equal; bound {r['bound_ms']:.4f} ms by ALU "
          f"instructions ({outputs} outputs x {THREEFRY_ALU_PER_OUTPUT} at "
          f"{sms} SMs x {ALU_LANES_PER_SM} lanes x {mhz:.0f} MHz), "
          f"{r['bound_bytes_ms']:.4f} ms by bytes ({r['bytes']} B); "
          f"{r['bound_ms'] / drawn['ms']:.3f} of the ALU bound", flush=True)


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
        s = open_session(graph, SpinnerConfig(k=K, max_iters=SESSION_ITERS),
                         EngineOptions(engine="fused", device=dev,
                                       score_backend=backend))
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
                               variant_launches=n_var, base_launches=n_base,
                               tile=fused_update_frontier.last_tile)
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
    report["fused_update_frontier_csr"]["tile"] = list(
        runs["cuda"][0]["adapt_b1_frontier"]["tile"])
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
        if overlap == "on":
            seeded_tile = list(fused_update_seeded.last_tile)
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
        launches=runs["on"]["seeded_launches"], tile=seeded_tile,
        max_abs_err=err,
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


MESH_MEDIUM_ITERS = 2      # (j2)'s depth: its CPU side draws ~1.5 s an
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
    cfg = SpinnerConfig(k=K, max_iters=SESSION_ITERS)
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
POISSON_DURATION, POISSON_RATE = 12.0, 0.25   # (k2), cut from 20 s


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


def phase_serve_fleet(graphs: list, t_build: float, dev, smi: str,
                      report: dict) -> list:
    """(k1) Eight same-bucket tenants of ~200,000 vertices (``graphs``,
    ``traffic.tenant_graph(SERVE_N + 17 i, seed=i, k_nbrs=16)`` built by
    ``start_host_graphs``' child in ``t_build`` s): naive serving, the
    scheduler serial and batched on the torch backend, and the scheduler
    on the CUDA backend (serial, K1), on one request stream; every ticket
    held to a twin session; returns the graphs."""
    from repro_torch.core import (EngineOptions, SpinnerConfig, delta,
                                  engine, open_session)
    from repro_torch.serve import traffic

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
          f" in bucket ({v_pad}, {e_pad}), built in {t_build:.3f}s beside "
          f"phases (b)-(j); bursts "
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


CLUSTER_ITERS, CLUSTER_SNAP, CLUSTER_FAULT = 8, 4, 6    # (l1) depth cut


def _cluster_run(tmp: str, name: str, world: int, job: dict) -> dict:
    """One ``ProcessClusterSupervisor`` job under ``tmp/name``: its output,
    wall seconds, labels and every worker's stats file.  A worker that
    fails to build or launch K2 exits non-zero; once the restart budget is
    spent the supervisor raises ``WorkerLost``, which ends the smoke (the
    workers' log tails go to stderr first)."""
    import os

    from repro_torch.cluster import (ProcessClusterConfig,
                                     ProcessClusterSupervisor, WorkerLost)

    wd = os.path.join(tmp, name)
    t0 = time.perf_counter()
    try:
        out = ProcessClusterSupervisor(
            ProcessClusterConfig(workdir=wd, num_processes=world), job).run()
    except WorkerLost:
        for log in sorted(os.listdir(wd)):
            if log.endswith(".log"):
                with open(os.path.join(wd, log)) as f:
                    print(f"--- {name}/{log}:\n{f.read()[-3000:]}",
                          file=sys.stderr)
        raise
    wall = time.perf_counter() - t0
    stats = {}
    for f in sorted(os.listdir(wd)):
        if f.startswith("stats_g") and f.endswith(".json"):
            with open(os.path.join(wd, f)) as fh:
                stats[f[len("stats_"):-len(".json")]] = json.load(fh)
    return dict(out=out, wall_s=wall, stats=stats,
                labels=np.load(os.path.join(wd, "labels.npy")))


def phase_cluster_workers(graph, dev, smi: str, report: dict) -> None:
    """(l1) The process cluster on one card: the full graph's edge shards
    for two hosts; two workers on cuda:0 under ``ProcessClusterSupervisor``
    lose worker 1 at superstep 6, the one-process generation resumes from
    the snapshot of superstep 4; an uninterrupted one-process job; the
    recovered labels identical to it, K2 launched once a superstep by
    every worker, and K2 on one worker's rows against its plain version."""
    import os
    import tempfile

    from repro_torch.cluster import write_edge_shards
    from repro_torch.cluster.worker import owned_csr
    from repro_torch.kernels import ref
    from repro_torch.kernels.spinner_scores import spinner_scores

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        shards = os.path.join(tmp, "shards")
        man = write_edge_shards(graph, shards, num_hosts=2)
        t_write = time.perf_counter() - t0
        job = {"shard_dir": shards, "k": K, "seed": 0,
               "max_iters": CLUSTER_ITERS, "snapshot_every": CLUSTER_SNAP,
               "device": str(dev), "rpc_timeout": 300}
        faulty = _cluster_run(tmp, "faulty", 2, {**job, "fault": {
            "gen": 0, "pid": 1, "iteration": CLUSTER_FAULT}})
        whole = _cluster_run(tmp, "uninterrupted", 1, job)
        out, gens = faulty["out"], faulty["out"]["generations"]
        check(out["restarts"] == 1 and [g["dead"] for g in gens] == [[1], []]
              and out["result"]["world"] == 1,
              f"(l1) restarts {out['restarts']}, generations {gens}")
        check(np.array_equal(faulty["labels"], whole["labels"]),
              "(l1) the recovered labels differ from the uninterrupted "
              "run's")
        check(out["result"]["phi"] == whole["out"]["result"]["phi"],
              f"(l1) phi {out['result']['phi']} != "
              f"{whole['out']['result']['phi']}")
        workers = {**{f"faulty {k}": v for k, v in faulty["stats"].items()},
                   **{f"uninterrupted {k}": v
                      for k, v in whole["stats"].items()}}
        want = {"faulty g0_p0": CLUSTER_FAULT, "faulty g0_p1": CLUSTER_FAULT,
                "faulty g1_p0": CLUSTER_ITERS - CLUSTER_SNAP,
                "uninterrupted g0_p0": CLUSTER_ITERS}
        check(sorted(workers) == sorted(want), f"(l1) workers {workers}")
        for w, st in workers.items():
            check(st["supersteps"] == want[w]
                  and st["k2_launches"] == st["supersteps"]
                  and st["device"].startswith(dev.type),
                  f"(l1) {w}: {st['supersteps']} supersteps, K2 "
                  f"{st['k2_launches']} launches on {st['device']}")
        print(f"(l1) [{smi}] shards of V={man['num_vertices']} for 2 hosts "
              f"written in {t_write:.3f}s; 2 workers on {dev} lost worker "
              f"1 at superstep {CLUSTER_FAULT}: restarts {out['restarts']}, "
              f"generations "
              f"{[(g['gen'], g['world'], g['dead'], round(g['seconds'], 3)) for g in gens]}"
              f", {faulty['wall_s']:.3f}s; uninterrupted 1-process job "
              f"{whole['wall_s']:.3f}s; recovered labels.npy identical to "
              f"the uninterrupted run's, phi {out['result']['phi']} equal; "
              f"K2 launches = supersteps for each worker "
              f"{ {w: st['k2_launches'] for w, st in workers.items()} }",
              flush=True)
        for w, st in workers.items():
            print(f"(l1) {w} ({st['rows']} rows, {st['entries']} entries) "
                  f"one superstep [{smi}]: " + ", ".join(
                      f"{p} {ms:.3f} ms" for p, ms in st["split_ms"].items()),
                  flush=True)

        # K2 over worker 0's rows of the 2-host layout, the uninterrupted
        # run's labels as the lookup, against its plain version
        rows, row_ptr, src, dst, w = owned_csr(
            shards, [0], man["v_per_host"], man["num_vertices"])
    rp_d, dst_d, w_d = (torch.from_numpy(a).to(dev)
                        for a in (row_ptr, dst, w))
    lookup = torch.from_numpy(whole["labels"]).to(dev)
    own = lookup[torch.from_numpy(rows).to(dev)]
    src_d = torch.from_numpy(src - int(rows[0])).to(dev)
    n, e = rows.size, src.size

    def k2():
        return spinner_scores(own, rp_d, dst_d, w_d, K, lookup=lookup)

    def k2_plain():
        return ref.spinner_scores_ref(lookup, src_d, dst_d, w_d, n, K)

    got, exp = k2(), k2_plain()
    torch.cuda.synchronize()
    check(bits_equal(got, exp), "(l1) K2 on worker 0's rows != its plain "
          "version")
    err = max_abs_err([(got, exp)])
    del got, exp
    ms, plain_ms = time_ms(k2, reps=20), time_ms(k2_plain, reps=5)
    nbytes = (n + 1) * 8 + e * 8 + n * 4 + lookup.numel() * 4 + n * K * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"(l1) K2 on worker 0's {n} rows ({e} entries, the full label "
          f"vector its lookup) [{smi}]: bitwise equal to its plain version "
          f"(max_abs_err {err}); {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound:.3f} ms for {nbytes} B", flush=True)
    report["cluster_workers"] = dict(
        write_s=t_write, faulty_wall_s=faulty["wall_s"],
        uninterrupted_wall_s=whole["wall_s"], generations=gens,
        phi=out["result"]["phi"], workers=workers,
        k2_launches=sum(st["k2_launches"] for st in workers.values()),
        k2_rows=dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bytes=nbytes,
                     max_abs_err=err, rows=int(n), entries=int(e)),
        card=smi)


def phase_cluster_supervisor(graph, medium, dev, smi: str,
                             report: dict) -> None:
    """(l2) ``PartitionSupervisor`` on the CUDA backend, full graph:
    ``partition`` + 3 ``adapt`` clean, with ``kill_worker_at(2)`` and with
    the newest snapshot torn first -- identical labels, the torn one
    skipped; on the medium graph a kill after two edge batches replays
    them (``add_edges`` on the host) to the clean run's labels."""
    import os
    import tempfile

    from repro_torch.cluster import (ClusterSupervisorConfig,
                                     PartitionSupervisor,
                                     corrupt_newest_snapshot_at,
                                     kill_worker_at)
    from repro_torch.core import EngineOptions, SpinnerConfig
    from repro_torch.kernels.spinner_scores import fused_update

    opts = EngineOptions(device=dev, score_backend="cuda")
    cfg = SpinnerConfig(k=K)
    work = [("partition", {})] + [("adapt", {})] * 3
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, faults in (
                ("clean", []), ("kill", [kill_worker_at(2)]),
                ("torn", [corrupt_newest_snapshot_at(2),
                          kill_worker_at(2)])):
            sup = PartitionSupervisor(
                ClusterSupervisorConfig(snapshot_dir=os.path.join(tmp, name)),
                lambda ndev: (graph, cfg, opts))
            k1 = fused_update.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session, results = sup.run(work, faults=faults)
            torch.cuda.synchronize()
            runs[name] = dict(
                wall_s=time.perf_counter() - t0, stats=sup.stats(),
                labels=session.labels.copy(), results=results,
                k1_launches=fused_update.launches - k1,
                iterations=[r.iterations for r in results])
            session.close()
        med = {}
        g = medium[0]
        gen = np.random.default_rng(17)
        d1, d2 = (tuple(gen.integers(0, g.num_vertices, 2000)
                        for _ in range(2)) for _ in range(2))
        mwork = [("partition", {}),
                 ("update", {"edge_src": d1[0], "edge_dst": d1[1]}),
                 ("adapt", {}), ("adapt", {"edge_updates": d2}),
                 ("adapt", {})]
        for name, faults in (("clean", []), ("kill", [kill_worker_at(4)])):
            sup = PartitionSupervisor(
                ClusterSupervisorConfig(
                    snapshot_dir=os.path.join(tmp, "medium_" + name)),
                lambda ndev: (g, cfg, opts))
            session, _ = sup.run(mwork, faults=faults)
            med[name] = (session.labels.copy(), session.delta_watermark,
                         sup.stats()["restarts"])
            session.close()
    clean = runs["clean"]
    check(clean["stats"]["restarts"] == 0
          and clean["k1_launches"] == sum(clean["iterations"]),
          f"(l2) clean: {clean['stats']['restarts']} restarts, K1 "
          f"{clean['k1_launches']} launches in {clean['iterations']}")
    for name in ("kill", "torn"):
        r, st = runs[name], runs[name]["stats"]
        check(st["restarts"] == 1 and st["snapshots_restored"] == 1
              and np.array_equal(r["labels"], clean["labels"])
              and all(np.array_equal(a.labels, b.labels) for a, b in
                      zip(r["results"], clean["results"])),
              f"(l2) {name}: restarts {st['restarts']}, labels differ from "
              "the clean run's")
    check(runs["torn"]["stats"]["corrupt_skipped"] >= 1
          and runs["torn"]["stats"]["snapshots_corrupted"] == 1,
          "(l2) the torn snapshot was not skipped")
    check(med["kill"][2] == 1 and med["kill"][1] == med["clean"][1] == 2
          and np.array_equal(med["kill"][0], med["clean"][0]),
          "(l2) the medium graph's replay of two edge batches differs")
    for name, r in runs.items():
        st = r["stats"]
        print(f"(l2) PartitionSupervisor {name} [{smi}]: partition + 3 "
              f"adapts on the full graph in {r['wall_s']:.3f}s, iterations "
              f"{r['iterations']}, K1 launches {r['k1_launches']}, restarts "
              f"{st['restarts']}, snapshots written/restored/skipped "
              f"{st['snapshots_written']}/{st['snapshots_restored']}/"
              f"{st['corrupt_skipped']}, recover seconds "
              f"{[round(x, 6) for x in st['recover_seconds']]}", flush=True)
    print(f"(l2) kill and torn runs identical to the clean run (every "
          f"item's labels); medium graph: a kill after two edge batches "
          f"replays them (watermark {med['kill'][1]}) to the clean run's "
          f"labels", flush=True)
    report["cluster_supervisor"] = {
        name: dict(wall_s=r["wall_s"], iterations=r["iterations"],
                   k1_launches=r["k1_launches"],
                   recover_seconds=r["stats"]["recover_seconds"],
                   corrupt_skipped=r["stats"]["corrupt_skipped"])
        for name, r in runs.items()}


def phase_cluster_deployment(graphs, dev, smi: str, report: dict) -> None:
    """(l3) ``PartitionScheduler(deployment=ClusterDeployment(...))`` over
    (k1)'s tenants on the CUDA backend: every tenant partitioned through
    the scheduler (snapshotted), then one round of bursts with tenant 0's
    dispatch poisoned once -- recovered from its snapshot and retried;
    every ticket identical to its twin session's."""
    import tempfile

    from repro_torch.cluster import ClusterDeployment
    from repro_torch.core import (EngineOptions, SpinnerConfig, delta,
                                  open_session)
    from repro_torch.kernels.spinner_scores import fused_update
    from repro_torch.serve import PartitionScheduler, traffic

    cfg = SpinnerConfig(k=K)
    opts = EngineOptions(device=dev, score_backend="cuda")
    gen = np.random.default_rng(23)
    bursts = [[traffic.random_edge_updates(g.num_vertices, SERVE_PAIRS, gen)
               for _ in range(SERVE_BURST)] for g in graphs]
    with tempfile.TemporaryDirectory() as tmp:
        dep = ClusterDeployment(tmp)
        sched = PartitionScheduler(deployment=dep)
        for i, g in enumerate(graphs):
            sched.add_tenant(f"t{i}", g, cfg, opts)
        k1 = fused_update.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = [sched.submit(f"t{i}", "partition")
                 for i in range(len(graphs))]
        sched.drain()
        # tenant 0's next run fails once, after its window's edges joined
        # the delta log (as a failed launch would)
        sess = sched.tenants["t0"].session
        orig, armed = sess._fast_bind, [True]

        def poisoned(*a, **kw):
            if armed[0]:
                armed[0] = False
                raise RuntimeError("injected dispatch failure")
            return orig(*a, **kw)

        sess._fast_bind = poisoned
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tks = [[sched.submit(f"t{i}", "edge_updates", edge_updates=b)
                for b in bs] for i, bs in enumerate(bursts)]
        sched.drain()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k1_launches = fused_update.launches - k1
        st = sched.stats()
    check(st["errors"] == 0 and st["queued"] == 0 and st["recoveries"] == 1
          and st["deployment"]["recoveries"] == 1 and not armed[0],
          f"(l3) errors {st['errors']}, recoveries {st['recoveries']}, "
          f"deployment {st['deployment']}")
    for i, g in enumerate(graphs):
        twin = open_session(g, cfg, opts)
        check(_same_result(parts[i].result,
                           twin.partition(record_history=False)),
              f"(l3) tenant {i}'s partition differs from its twin's")
        want = twin.adapt(edge_updates=delta.coalesce_updates(bursts[i]),
                          record_history=False)
        check(all(tk.result is tks[i][-1].result for tk in tks[i])
              and _same_result(tks[i][-1].result, want),
              f"(l3) tenant {i}'s window differs from its twin's adapt")
        twin.close()
    iters = sum(p.result.iterations for p in parts) + sum(
        row[-1].result.iterations for row in tks)
    print(f"(l3) PartitionScheduler(deployment=ClusterDeployment) [{smi}]: "
          f"{len(graphs)} CUDA-backend tenants partitioned through the "
          f"scheduler in {t1 - t0:.3f}s, then {len(graphs) * SERVE_BURST} "
          f"edge-update requests with tenant 0's dispatch poisoned once, "
          f"drained in {t2 - t1:.3f}s; recoveries {st['recoveries']}, "
          f"snapshots written {st['deployment']['snapshots_written']}, "
          f"errors {st['errors']}; K1 launches {k1_launches} (iterations "
          f"{iters} plus the failed window's); every ticket identical to "
          f"its twin session's", flush=True)
    report["cluster_deployment"] = dict(
        partition_s=t1 - t0, round_s=t2 - t1, recoveries=st["recoveries"],
        snapshots_written=st["deployment"]["snapshots_written"],
        k1_launches=k1_launches, iterations=iters, card=smi)


# ---------------------------------------------------------------------------
# (m) the LLM scaffolding: serve and train stablelm-1.6b at full width

LLM_ARCH, MOE_ARCH = "stablelm-1.6b", "qwen3-moe-235b-a22b"
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 (NVIDIA data sheet)
SERVE_ARGS = ["--arch", LLM_ARCH, "--no-reduced", "--batch", "8",
              "--prompt-len", "1024", "--gen", "64", "--check", "4"]
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 4, 4096, 4   # train_4k, batch cut
TRAIN_ARGS = ["--arch", LLM_ARCH, "--steps", str(TRAIN_STEPS), "--seq-len",
              str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH),
              "--ckpt-every", "1000"]
MOE_LAYERS, MOE_BATCH, MOE_PROMPT, MOE_GEN = 2, 4, 512, 16
CKPT_ROOM = 21e9                   # (m2)'s checkpoint: 19.7 GB + slack


def _run_child(tag: str, module: str, args: list, timeout: float) -> dict:
    """``python -m <module> <args>`` from the checkout; echoes its output
    under ``tag`` and returns the JSON record its last line holds.  A child
    that exits non-zero ends the smoke."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    lines = out.stdout.strip().splitlines()
    for ln in lines[:-1]:
        print(f"{tag}   | {ln}", flush=True)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
    check(out.returncode == 0, f"{tag} {module} exited {out.returncode}")
    rec = json.loads(lines[-1])
    rec = next(iter(rec.values()))
    rec["child_wall_s"] = time.perf_counter() - t0
    return rec


def _decode_bytes(cfg, batch: int, pos: float, src_len: int = 0) -> float:
    """Bytes one decode step at position ``pos`` must move: the serving
    copy's weights once (bf16; the leaves kept float32 at 4 bytes; the
    embedding only its ``batch`` rows; not the encoder, which decode does
    not run, nor the cross-attention's K/V projections, whose output the
    cross cache holds), the cache or state it reads and writes, and the
    bf16 logits written.  Self-attention caches are read up to ``pos``
    and written at it; cross caches (``src_len`` or ``n_img_tokens``
    positions) are read; recurrent states are read and written whole."""
    import math

    from repro_torch.launch.serve_llm import _F32_LEAVES
    from repro_torch.models import build
    from repro_torch.models.common import tree_leaves_with_path
    api = build(cfg)
    weights = 0
    for path, s in tree_leaves_with_path(api.param_specs):
        if path == "embed":
            weights += batch * cfg.d_model * 2
        elif not (path.startswith("enc") or path.endswith(
                ("cross/wk", "cross/wv", "cross_layers/attn/wk",
                 "cross_layers/attn/wv"))):
            weights += math.prod(s.shape) * (
                4 if any(f in path for f in _F32_LEAVES) else 2)
    kv_pos = batch * cfg.n_kv_heads * cfg.hd * 2 * 2     # k and v, bf16
    if cfg.family == "rwkv":
        state = 2 * sum(math.prod(s.shape) * s.dtype.itemsize
                        for _, s in tree_leaves_with_path(
                            api.cache_specs(batch, 1)))
    elif cfg.family == "hybrid":
        st = api.cache_specs(batch, 1)
        state = 2 * sum(math.prod(s.shape) * s.dtype.itemsize
                        for _, s in tree_leaves_with_path((st.mamba,
                                                           st.tail)))
        state += st.attn.k.shape[0] * kv_pos * (pos + 2)
    elif cfg.family == "encdec":
        state = cfg.n_layers * kv_pos * (pos + 2 + src_len)
    elif cfg.family == "vlm":
        groups = cfg.n_layers // cfg.cross_attn_period
        state = (cfg.n_layers - groups) * kv_pos * (pos + 2) \
            + groups * kv_pos * cfg.n_img_tokens
    else:
        state = cfg.n_layers * kv_pos * (pos + 2)
    vocab = cfg.vocab if cfg.family == "vlm" else cfg.vocab_padded
    return weights + state + batch * vocab * 2


def phase_llm_serve(smi: str, report: dict) -> None:
    """(m1) ``repro_torch.launch.serve_llm`` serving stablelm-1.6b at full
    width and depth: 8 prompts of 1024 tokens, 64 generated each, the first
    4 decode steps held to one forward (decode-matches-prefill)."""
    from repro_torch.configs import ARCHS
    rec = _run_child("(m1)", "repro_torch.launch.serve_llm", SERVE_ARGS, 600)
    cfg = ARCHS[rec["arch"]].reduced() if rec["reduced"] else \
        ARCHS[rec["arch"]]
    mean_pos = rec["prompt_len"] + (rec["gen"] - 2) / 2
    nbytes = _decode_bytes(cfg, rec["batch"], mean_pos)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rec.update(decode_bytes=nbytes, decode_bound_ms=bound_ms)
    print(f"(m1) serve_llm {LLM_ARCH} full width ({rec['params']} params, "
          f"bf16 serving copy) [{smi}]: prefill {rec['batch']}x"
          f"{rec['prompt_len']} {rec['prefill_s']:.4f}s, decode "
          f"{rec['decode_ms_per_step']:.3f} ms/step = "
          f"{rec['decode_tokens_per_s']:.1f} tokens/s over {rec['gen'] - 1} "
          f"steps, peak {rec['peak_bytes'] / 2**30:.2f} GiB; decode byte "
          f"bound {bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB at the mean "
          f"position {mean_pos:.0f}; {bound_ms / rec['decode_ms_per_step']:.3f}"
          f" of it); decode-matches-prefill over "
          f"{rec['check']['positions']} positions, max |diff| "
          f"{rec['check']['max_abs_diff']:.4f} (atol 0.1, rtol 0.05); child "
          f"{rec['child_wall_s']:.1f}s", flush=True)
    report["llm_serve"] = rec


def _product_terms(cfg, batch: int, seq: int, src_len: int = None):
    """(forward products, rematerialized products): the sum over the
    weight matrices of their elements times the tokens they multiply, for
    one forward over ``batch`` x ``seq`` tokens (an encoder over ``batch``
    x ``src_len``, an image of ``n_img_tokens``); the second counts only
    what remat recomputes (the layers; the hybrid's groups, not its tail).
    Gathers (the embedding), vectors and the attention's and scans' own
    products are left out."""
    import math

    from repro_torch.models import build
    from repro_torch.models.common import tree_leaves_with_path
    tokens = batch * seq
    src = batch * (src_len or seq)
    img = batch * cfg.n_img_tokens
    # leading stacked axes of each subtree: a leaf with 2 dims past them is
    # a weight matrix
    stacked = {"layers": 1, "mamba": 2, "mamba_tail": 1, "enc_layers": 1,
               "dec_layers": 1, "self_layers": 2, "cross_layers": 1}
    groups = cfg.n_layers // cfg.attn_period if cfg.attn_period else 0
    fwd = remat = 0
    for path, s in tree_leaves_with_path(build(cfg).param_specs):
        top = path.split("/")[0]
        if top == "embed" or len(s.shape) - stacked.get(top, 0) < 2 or \
                path.endswith("bonus_u"):
            continue
        n = math.prod(s.shape)
        if top == "enc_layers" or path.endswith(("cross/wk", "cross/wv")):
            n *= src
        elif path.startswith(("cross_layers/attn/wk",
                              "cross_layers/attn/wv")):
            n *= img
        elif top == "shared_attn":
            n *= tokens * groups
        elif "/exp_w" in path:
            n *= tokens * cfg.top_k / cfg.n_experts
        else:
            n *= tokens
        fwd += n
        if top not in ("lm_head", "mamba_tail"):
            remat += n
    return fwd, (remat if cfg.remat else 0)


def _train_flops(cfg, batch: int, seq: int, src_len: int = None) -> float:
    """A forward and backward: 6 FLOP per product of the forward (2 for it,
    4 for its backward) plus 2 per product that remat recomputes."""
    fwd, remat = _product_terms(cfg, batch, seq, src_len)
    return 6 * fwd + 2 * remat


def _train_child(tag: str, args: list, need: float) -> dict:
    """``python -m repro_torch.launch.train <args>`` with its checkpoint
    under ``build/`` (or the temp dir) where ``need`` bytes are free; the
    losses and grad norms must be finite; the checkpoint is deleted
    after."""
    import os
    import shutil
    import tempfile

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    dirs = [str(root), tempfile.gettempdir()]
    free = {d: shutil.disk_usage(d).free for d in dirs}
    base = next((d for d in dirs if free[d] >= need), None)
    check(base is not None, f"{tag} no room for the {need / 1e9:.0f} GB "
          f"checkpoint: free bytes {free}")
    ckpt = os.path.join(base, "llm_train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        rec = _run_child(tag, "repro_torch.launch.train",
                         args + ["--ckpt-dir", ckpt], 900)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(len(rec["loss"]) == rec["steps"] and all(
        np.isfinite(rec["loss"])) and all(np.isfinite(rec["grad_norm"])),
        f"{tag} non-finite loss or grad norm: {rec['loss']} "
        f"{rec['grad_norm']}")
    rec.update(ckpt_base=base, ckpt_free_bytes=free[base])
    return rec


def _print_train(tag: str, rec: dict, batch: int, seq: int, smi: str
                 ) -> None:
    from repro_torch.configs import ARCHS
    cfg = ARCHS[rec["arch"]].reduced() if rec["reduced"] else \
        ARCHS[rec["arch"]]
    flops = _train_flops(cfg, batch, seq)
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    save_s = rec["saves"][-1][1]
    rec.update(flops=flops, bound_ms=bound_ms)
    print(f"{tag} train {rec['arch']} full width [{smi}]: {rec['steps']} "
          f"steps of {batch}x{seq} tokens, step times "
          f"{[round(x * 1e3, 1) for x in rec['step_s']]} ms, "
          f"{rec['ms_per_step']:.1f} ms/step (median after the first) = "
          f"{rec['tokens_per_s']:.0f} tokens/s; losses "
          f"{[round(x, 4) for x in rec['loss']]}, grad norms "
          f"{[round(x, 3) for x in rec['grad_norm']]}; peak "
          f"{rec['peak_bytes'] / 2**30:.2f} GiB; bf16 FLOP bound "
          f"{bound_ms:.1f} ms ({flops:.4e} FLOP; "
          f"{bound_ms / rec['ms_per_step']:.3f} of it); checkpoint "
          f"{rec['ckpt_bytes'] / 1e9:.3f} GB saved in {save_s:.2f}s "
          f"({rec['ckpt_bytes'] / save_s / 1e9:.2f} GB/s) under "
          f"{rec['ckpt_base']} ({rec['ckpt_free_bytes'] / 1e9:.1f} GB free "
          f"before), deleted; child {rec['child_wall_s']:.1f}s", flush=True)


def phase_llm_train(smi: str, report: dict) -> None:
    """(m2) ``repro_torch.launch.train``: stablelm-1.6b at full width and
    depth, 4 steps of 4 x 4096 tokens (train_4k's length, its batch of 256
    cut to 4), remat on; finite loss and grad norm; the supervisor's final
    checkpoint (params + m + v) timed, sized and deleted."""
    rec = _train_child("(m2)", TRAIN_ARGS, CKPT_ROOM)
    _print_train("(m2)", rec, TRAIN_BATCH, TRAIN_SEQ, smi)
    report["llm_train"] = rec


def phase_llm_moe(dev, smi: str, report: dict) -> None:
    """(m3) qwen3-moe-235b-a22b at full width (E 128, top-8, d_expert
    1536), depth cut to 2 layers: a prefill of 4 x 512, 16 decode steps,
    and one ``loss_fn`` forward + backward (no optimizer step); the
    ``"sort"`` dispatch's loss equal to the ``"cumsum"`` one's within rel
    2e-2."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.data import pipeline
    from repro_torch.launch.serve_llm import grow_cache
    from repro_torch.models import build, init_params
    from repro_torch.models.common import (tree_leaves,
                                           use_reference_numerics)
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.steps import value_and_grad

    use_reference_numerics()
    cfg = dataclasses.replace(ARCHS[MOE_ARCH], n_layers=MOE_LAYERS)
    api = build(cfg)
    torch.cuda.synchronize(dev)          # the context exists before a reset
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(api, torch.Generator(device=dev).manual_seed(0))
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=MOE_PROMPT,
                               global_batch=MOE_BATCH, seed=3)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipeline.batch_at(data, 0).items()}
    times = []
    for _ in range(2):      # the first call also loads the device's kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = api.prefill(params, {"tokens": batch["tokens"]})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    prefill_s = times[1]
    cache = grow_cache(cache, MOE_PROMPT + MOE_GEN, cfg.family)
    tok = torch.argmax(logits[:, -1], dim=-1)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(MOE_GEN):
            logits, cache = api.decode(params, {"token": tok,
                                                "pos": MOE_PROMPT + i}, cache)
            tok = torch.argmax(logits[:, -1], dim=-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / MOE_GEN * 1e3
    check(bool(torch.isfinite(logits.float()).all()), "(m3) decode logits "
          "not finite")
    del cache, logits
    t0 = time.perf_counter()
    loss, grads = value_and_grad(api.loss, params, batch)
    gnorm = float(global_norm(grads))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    n_grads = len(tree_leaves(grads))
    del grads
    torch.cuda.empty_cache()
    sorted_api = build(dataclasses.replace(cfg, moe_dispatch="sort"))
    with torch.no_grad():
        loss_sort = float(sorted_api.loss(params, batch))
    loss = float(loss)
    rel = abs(loss_sort - loss) / abs(loss)
    check(np.isfinite(loss) and np.isfinite(gnorm) and rel <= 2e-2,
          f"(m3) loss {loss} (cumsum) vs {loss_sort} (sort), grad norm "
          f"{gnorm}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"(m3) {MOE_ARCH} full width, {MOE_LAYERS} layers "
          f"({api.num_params} params, {api.num_active_params} active) "
          f"[{smi}]: prefill {MOE_BATCH}x{MOE_PROMPT} {prefill_s:.4f}s "
          f"(first call {times[0]:.4f}s), "
          f"decode {decode_ms:.3f} ms/step over {MOE_GEN} steps; loss_fn "
          f"forward + backward {step_s:.3f}s, loss {loss:.6f} (cumsum), "
          f"{loss_sort:.6f} (sort; rel {rel:.2e}), grad norm {gnorm:.4f} "
          f"over {n_grads} leaves; peak {peak / 2**30:.2f} GiB", flush=True)
    report["llm_moe"] = dict(params=api.num_params, prefill_s=prefill_s,
                             prefill_first_s=times[0],
                             decode_ms=decode_ms, step_s=step_s, loss=loss,
                             loss_sort=loss_sort, grad_norm=gnorm,
                             peak_bytes=peak)
    del params
    torch.cuda.empty_cache()


def _reduced_on_card(arch: str, dev, tag: str) -> dict:
    """``arch``'s reduced() config on the card against the port's CPU with
    the same weights and inputs (``pipeline``'s 4 x 64 tokens and the
    frontend stub): the loss (rtol 1e-3), the logits of a 48-token prefill
    and 4 decode steps, and the final cache or state (atol 5e-2)."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import pipeline
    from repro_torch.launch.serve_llm import frontend_inputs, grow_cache
    from repro_torch.models import build, init_params
    from repro_torch.models.common import tree_leaves, tree_map

    cpu = torch.device("cpu")
    cfg = ARCHS[arch].reduced()
    api = build(cfg)
    params = init_params(api, torch.Generator().manual_seed(0))
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                               seed=4)
    host = {k: torch.from_numpy(v)
            for k, v in pipeline.batch_at(data, 0).items()}
    host.update(frontend_inputs(cfg, 4, 48, torch.Generator().manual_seed(1),
                                cpu))
    outs = []
    for d in (cpu, dev):
        p = tree_map(lambda t: t.to(d), params)
        b = {k: v.to(d) for k, v in host.items()}
        prompt = {k: v[:, :48] if k == "tokens" else v for k, v in b.items()
                  if k != "labels"}
        with torch.no_grad():
            loss = float(api.loss(p, b))
            logits, cache = api.prefill(p, prompt)
            cache = grow_cache(cache, 52, cfg.family)
            lg = [logits.float().cpu()]
            for t in range(48, 52):
                step, cache = api.decode(p, {"token": b["tokens"][:, t],
                                             "pos": t}, cache)
                lg.append(step.float().cpu())
        outs.append((loss, torch.stack(lg),
                     [c.float().cpu() for c in tree_leaves(cache)]))
    (lc, oc, cc), (lg, og, cg) = outs
    err = float((og - oc).abs().max())
    state_err = max(float((a - b).abs().max()) for a, b in zip(cg, cc))
    check(abs(lg - lc) <= 1e-3 * abs(lc) and err <= 5e-2
          and state_err <= 5e-2, f"{tag} {arch}: card loss {lg} vs CPU "
          f"{lc}, logits max |diff| {err}, cache or state {state_err}")
    return dict(loss_card=lg, loss_cpu=lc, logits_max_abs=err,
                state_max_abs=state_err)


def phase_llm_parity(dev, smi: str, report: dict) -> None:
    """(m4) The card against the port's CPU at reduced() stablelm-1.6b and
    qwen3-moe (:func:`_reduced_on_card`); the flash autograd.Function's grads (atol 5e-2,
    rtol 2e-2); and a training run stopped after 2 of 4 steps and
    restored from its checkpoint bit-identical to the uninterrupted one."""
    import tempfile

    from repro_torch.configs import ARCHS
    from repro_torch.data import pipeline
    from repro_torch.models import build, init_params
    from repro_torch.models.attention import chunked_attention
    from repro_torch.models.common import tree_leaves, use_reference_numerics
    from repro_torch.optim import adamw
    from repro_torch.runtime import SupervisorConfig, TrainSupervisor
    from repro_torch.train import steps

    use_reference_numerics()
    cpu = torch.device("cpu")
    worst = {arch: _reduced_on_card(arch, dev, "(m4)")
             for arch in (LLM_ARCH, MOE_ARCH)}

    gen = torch.Generator().manual_seed(2)
    q = torch.randn(2, 256, 8, 64, generator=gen)
    k, v = (torch.randn(2, 256, 2, 64, generator=gen) for _ in range(2))
    co = torch.randn(2, 256, 8, 64, generator=gen)
    flash = []
    for d in (cpu, dev):
        ts = [t.to(d).requires_grad_(True) for t in (q, k, v)]
        out = chunked_attention(*ts, causal=True, chunk_q=64, chunk_kv=64)
        flash.append([out.detach().float().cpu()] + [
            g.cpu() for g in torch.autograd.grad(
                (out.float() * co.to(d)).sum(), ts)])
    flash_err = 0.0
    for a, b in zip(flash[1], flash[0]):
        excess = float(((a - b).abs() - 5e-2 - 2e-2 * b.abs()).max())
        flash_err = max(flash_err, float((a - b).abs().max()))
        check(excess <= 0, f"(m4) flash grads on the card differ from the "
              f"CPU's by {flash_err}")

    cfg = ARCHS[LLM_ARCH].reduced()
    api = build(cfg)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8,
                               seed=5)
    step = steps.make_train_step(api, opt)

    def batch_fn(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in pipeline.batch_at(data, i).items()}

    def fresh():
        return steps.init_train_state(init_params(
            api, torch.Generator().manual_seed(0), dev))

    with tempfile.TemporaryDirectory() as tmp:
        whole = TrainSupervisor(SupervisorConfig(f"{tmp}/a", 100),
                                fresh()).run(step, batch_fn, 4)
        first = TrainSupervisor(SupervisorConfig(f"{tmp}/b", 2), fresh())
        try:
            first.run(step, batch_fn, 4, crash_at=2)
        except RuntimeError:
            pass
        second = TrainSupervisor(SupervisorConfig(f"{tmp}/b", 2), fresh())
        check(second.start_step == 2, "(m4) no checkpoint at step 2")
        resumed = second.run(step, batch_fn, 4)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(whole),
                                                 tree_leaves(resumed)))
    check(same, "(m4) the restarted run is not bit-identical to the "
          "uninterrupted one")
    print(f"(m4) the card against the CPU [{smi}]: "
          + "; ".join(f"{a} loss {w['loss_card']:.6f} vs {w['loss_cpu']:.6f},"
                      f" prefill + 4 decode logits max |diff| "
                      f"{w['logits_max_abs']:.4f}" for a, w in worst.items())
          + f"; flash out + grads max |diff| {flash_err:.4f} (atol 5e-2, "
          f"rtol 2e-2); 2 + 2 steps restored from the step-2 checkpoint "
          f"bit-identical to 4 uninterrupted steps", flush=True)
    report["llm_parity"] = dict(models=worst, flash_max_abs=flash_err,
                                restart_bit_identical=same)


def _kernel_split(fn, dev) -> dict:
    """``fn`` once under ``torch.profiler``: the device's busy time (the sum
    of its kernels' times), the kernels grouped by kind, the top five by
    name.  Times in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    kinds = {"gemm": 0.0, "elementwise": 0.0, "reduce": 0.0, "copy": 0.0,
             "other": 0.0}
    by_name = []
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        kind = ("gemm" if any(w in name for w in ("gemm", "cutlass", "sm90",
                                                   "xmma", "cublas", "nvjet"))
                else "reduce" if "reduce" in name
                else "copy" if any(w in name for w in ("copy", "cat",
                                                       "memcpy", "memset"))
                else "elementwise" if "elementwise" in name
                else "other")
        kinds[kind] += ms
        by_name.append((ms, e.key[:70], e.count))
    by_name.sort(reverse=True)
    return dict(busy_ms=sum(kinds.values()), kinds=kinds, top=by_name[:5])


def _print_split(tag: str, wall_ms: float, split: dict, smi: str) -> None:
    busy = split["busy_ms"]
    print(f"{tag} [{smi}]: {wall_ms:.3f} ms wall, device busy {busy:.3f} ms "
          f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}); by kind "
          + ", ".join(f"{k} {v:.3f}" for k, v in split["kinds"].items())
          + "; top kernels " + "; ".join(
              f"{n} x{c} {ms:.3f}" for ms, n, c in split["top"]),
          flush=True)


def phase_llm_split(dev, smi: str, report: dict) -> None:
    """(m5) Where a full-width stablelm-1.6b train step and decode step
    spend their time: the train step (4 x 4096 tokens) timed as forward,
    backward and AdamW update, then profiled; a decode step (batch 8 at
    position 1056 of a 1088-position cache, the bf16 serving copy) timed
    and profiled.  The idle share is 1 - device busy / unprofiled wall."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import pipeline
    from repro_torch.launch.serve_llm import serving_params
    from repro_torch.models import build, common, init_params
    from repro_torch.models.common import tree_leaves, tree_unflatten
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    common.use_reference_numerics()
    cfg = ARCHS[LLM_ARCH]
    api = build(cfg)
    route = ("bf16 mm/bmm with out_dtype=float32" if common._out_dtype_mm(
        dev.type) else "float32 products of the bf16-rounded operands")
    state = steps.init_train_state(init_params(
        api, torch.Generator(device=dev).manual_seed(0)))
    opt = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipeline.batch_at(data, 0).items()}
    step = steps.make_train_step(api, opt)
    state, _ = step(state, batch)                       # warm
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        parts[name] = (time.perf_counter() - t0) * 1e3
        return out

    leaves = [p.detach().requires_grad_(True)
              for p in tree_leaves(state.params)]
    with torch.enable_grad():
        loss = timed("forward", lambda: api.loss(
            tree_unflatten(state.params, leaves), batch))
        grads = timed("backward", lambda: torch.autograd.grad(loss, leaves))
    timed("adamw", lambda: adamw.update(
        opt, tree_unflatten(state.params, list(grads)), state.opt,
        state.params))
    del loss, grads, leaves
    timed("step", lambda: step(state, batch))
    split = _kernel_split(lambda: step(state, batch), dev)
    print(f"(m5) one train step of {LLM_ARCH}, {TRAIN_BATCH}x{TRAIN_SEQ} "
          f"tokens [{smi}]: forward {parts['forward']:.1f} ms, backward "
          f"(remat forward included) {parts['backward']:.1f}, AdamW "
          f"{parts['adamw']:.1f}; float32 score products: {route}",
          flush=True)
    _print_split("(m5) train step", parts["step"], split, smi)
    report["llm_split"] = dict(train=dict(parts, **split), route=route)
    serve = serving_params(state.params)
    del state
    torch.cuda.empty_cache()
    b, pos, smax = 8, 1056, 1088
    cache = api.cache_specs(b, smax)
    cache = type(cache)(*(torch.randn(c.shape, device=dev).to(c.dtype)
                          for c in cache))
    tok = torch.zeros(b, dtype=torch.int32, device=dev)

    def decode():
        with torch.no_grad():
            return api.decode(serve, {"token": tok, "pos": pos}, cache)

    decode()
    reps = []
    for _ in range(5):
        timed("decode", decode)
        reps.append(parts["decode"])
    parts["decode"] = statistics.median(reps)
    split = _kernel_split(decode, dev)
    _print_split(f"(m5) one decode step (batch {b}, position {pos})",
                 parts["decode"], split, smi)
    report["llm_split"]["decode"] = dict(wall_ms=parts["decode"], **split)
    del serve, cache
    torch.cuda.empty_cache()


def phase_llm(dev, smi: str, report: dict) -> None:
    """(m): (m1)-(m5) in order, with the phase's wall time."""
    t0 = time.perf_counter()
    phase_llm_serve(smi, report)
    phase_llm_train(smi, report)
    phase_llm_moe(dev, smi, report)
    phase_llm_parity(dev, smi, report)
    phase_llm_split(dev, smi, report)
    print(f"(m) phase (m) took {time.perf_counter() - t0:.3f}s [{smi}]",
          flush=True)


# ---------------------------------------------------------------------------
# (n) the rwkv, hybrid, encdec and vlm families at full width

G2_ARCHS = ("rwkv6-1.6b", "zamba2-7b", "seamless-m4t-large-v2",
            "llama-3.2-vision-11b")
G2_BATCH, G2_PROMPT, G2_GEN, G2_CHECK = 8, 1024, 20, 16
ENCDEC_ARCH = "seamless-m4t-large-v2"
G2_TRAIN_STEPS, G2_TRAIN_SEQ, G2_TRAIN_BATCH = 3, 1024, 4
G2_TRAIN_ARGS = ["--arch", ENCDEC_ARCH, "--steps", str(G2_TRAIN_STEPS),
                 "--seq-len", str(G2_TRAIN_SEQ), "--global-batch",
                 str(G2_TRAIN_BATCH), "--ckpt-every", "1000"]
G2_CKPT_ROOM = 27e9                # (n2)'s checkpoint: 24.4 GB + slack
# (n3) depth cuts, forced by float32 params + grads: zamba2-7b 2 x 27 GB
# and llama-3.2-vision-11b 2 x 39 GB at full depth
G2_FB = (("rwkv6-1.6b", None), ("zamba2-7b", 15),
         ("llama-3.2-vision-11b", 10))
G2_FB_BATCH, G2_FB_SEQ = 2, 2048
G2_DECODE_POS, G2_DECODE_LEN = 1056, 1088   # (n5)'s zamba2 decode step


def phase_g2_serve(smi: str, report: dict) -> None:
    """(n1) ``serve_llm`` for each of the four families at full width and
    depth in its own process: 8 prompts of 1024 tokens (the encdec's
    source and the vlm's 1600 image tokens from the frontend stub), 20
    generated, the first 16 decode steps held to one forward; each beside
    its family's decode byte bound."""
    from repro_torch.configs import ARCHS
    out = {}
    for arch in G2_ARCHS:
        cfg = ARCHS[arch]
        n_check = 0 if cfg.family == "hybrid" else G2_CHECK    # (n1b)
        rec = _run_child("(n1)", "repro_torch.launch.serve_llm", [
            "--arch", arch, "--no-reduced", "--batch", str(G2_BATCH),
            "--prompt-len", str(G2_PROMPT), "--gen", str(G2_GEN),
            "--check", str(n_check)], 600)
        if n_check:
            check(rec["check"]["positions"] == n_check + 1,
                  f"(n1) {arch}: {rec['check']}")
            held = (f"decode-matches-prefill over "
                    f"{rec['check']['positions']} positions, max |diff| "
                    f"{rec['check']['max_abs_diff']:.4f} (atol 0.1, rtol "
                    f"0.05)")
        else:
            held = "decode held to the forward block by block in (n1b)"
        mean_pos = rec["prompt_len"] + (rec["gen"] - 2) / 2
        nbytes = _decode_bytes(cfg, rec["batch"], mean_pos,
                               rec["prompt_len"])
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec.update(decode_bytes=nbytes, decode_bound_ms=bound_ms)
        print(f"(n1) serve_llm {arch} ({cfg.family}) full width and depth "
              f"({rec['params']} params, bf16 serving copy) [{smi}]: "
              f"prefill {rec['batch']}x{rec['prompt_len']} "
              f"{rec['prefill_s']:.4f}s (first call "
              f"{rec['prefill_first_s']:.3f}s), decode "
              f"{rec['decode_ms_per_step']:.3f} ms/step = "
              f"{rec['decode_tokens_per_s']:.1f} tokens/s over "
              f"{rec['gen'] - 1} steps, peak {rec['peak_bytes'] / 2**30:.2f}"
              f" GiB; decode byte bound {bound_ms:.3f} ms "
              f"({nbytes / 1e9:.3f} GB at the mean position {mean_pos:.0f};"
              f" {bound_ms / rec['decode_ms_per_step']:.3f} of it); "
              f"{held}; child {rec['child_wall_s']:.1f}s", flush=True)
        out[arch] = rec
    report["g2_serve"] = out


def phase_g2_train(smi: str, report: dict) -> None:
    """(n2) ``repro_torch.launch.train`` on seamless-m4t-large-v2 at full
    width and depth (the ``src_embed`` frontend stub in the launcher), 3
    steps of 4 x 1024 tokens; the 24.4 GB checkpoint saved and deleted."""
    rec = _train_child("(n2)", G2_TRAIN_ARGS, G2_CKPT_ROOM)
    _print_train("(n2)", rec, G2_TRAIN_BATCH, G2_TRAIN_SEQ, smi)
    report["g2_train"] = rec


def _g2_batch(cfg, batch: int, seq: int, dev, seed: int = 3) -> dict:
    """``pipeline``'s tokens and labels and the frontend stub (bf16)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    data = pipeline.DataConfig(vocab=cfg.vocab, seq_len=seq,
                               global_batch=batch, seed=seed)
    out = {k: torch.from_numpy(v).to(dev)
           for k, v in pipeline.batch_at(data, 0).items()}
    stub = pipeline.frontend_stub(cfg, ShapeConfig("train", seq, batch,
                                                   "train"), 0)
    if stub is not None:
        key = "src_embed" if cfg.family == "encdec" else "img_embed"
        out[key] = torch.from_numpy(stub).to(dev, torch.bfloat16)
    return out


def phase_g2_forward_backward(dev, smi: str, report: dict) -> None:
    """(n3) one ``loss_fn`` forward + backward (no optimizer) at full width
    on 2 x 2048 tokens, float32 params, remat on: rwkv6-1.6b at full depth,
    zamba2-7b cut to 15 layers (2 groups of 6 + the 3-block tail),
    llama-3.2-vision-11b cut to 10 (2 groups of 5; 1600 image tokens).
    (n5) first: rwkv6-1.6b's at full width cut to 2 layers (a layer's
    split is the same at any depth; the profiler's cost grows with the
    ~400,000 launches of the full depth), warm, timed and profiled; it
    loads every kernel the full depth runs, so that one runs once.  The
    others run twice and the second, warm call is timed."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import build, common, init_params
    from repro_torch.train.steps import value_and_grad

    common.use_reference_numerics()

    def setup(cfg):
        api = build(cfg)
        params = init_params(api, torch.Generator(device=dev).manual_seed(0))
        return api, params, _g2_batch(cfg, G2_FB_BATCH, G2_FB_SEQ, dev)

    def timed(api, params, batch):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, grads = value_and_grad(api.loss, params, batch)
        finite = all(bool(torch.isfinite(g).all())
                     for g in common.tree_leaves(grads))
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3, float(loss), finite

    cfg = dataclasses.replace(ARCHS["rwkv6-1.6b"], n_layers=2)
    api, params, batch = setup(cfg)
    timed(api, params, batch)
    wall, _, _ = timed(api, params, batch)
    split = _kernel_split(lambda: value_and_grad(api.loss, params, batch),
                          dev)
    _print_split(f"(n5) rwkv6-1.6b loss_fn forward + backward, full width "
                 f"cut to 2 layers ({G2_FB_BATCH}x{G2_FB_SEQ} tokens, "
                 f"{G2_FB_SEQ // cfg.seq_chunk} chunk steps a layer)", wall,
                 split, smi)
    report.setdefault("g2_split", {})["rwkv_train_2_layers"] = dict(
        wall_ms=wall, **split)
    del params, batch
    torch.cuda.empty_cache()

    out = {}
    for arch, layers in G2_FB:
        cfg = ARCHS[arch] if layers is None else \
            dataclasses.replace(ARCHS[arch], n_layers=layers)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)     # earlier phases' tensors
        api, params, batch = setup(cfg)
        runs = [timed(api, params, batch)
                for _ in range(1 if arch == "rwkv6-1.6b" else 2)]
        wall, loss, finite = runs[-1]
        check(finite and np.isfinite(loss), f"(n3) {arch}: loss {loss}, "
              f"grads finite {finite}")
        peak = torch.cuda.max_memory_allocated(dev) - held
        flops = _train_flops(cfg, G2_FB_BATCH, G2_FB_SEQ)
        bound_ms = flops / BF16_FLOPS_PER_S * 1e3
        depth = "full depth" if layers is None else \
            f"cut to {layers} of {ARCHS[arch].n_layers} layers"
        first = f" (first call {runs[0][0]:.1f})" if len(runs) > 1 else ""
        print(f"(n3) {arch} full width, {depth} ({api.num_params} params, "
              f"float32) [{smi}]: loss_fn forward + backward on "
              f"{G2_FB_BATCH}x{G2_FB_SEQ} tokens {wall:.1f} ms{first}, loss "
              f"{loss:.6f}, all grads finite {finite}; bf16 FLOP bound "
              f"{bound_ms:.1f} ms ({flops:.4e} FLOP; {bound_ms / wall:.3f} "
              f"of it); peak {peak / 2**30:.2f} GiB above the "
              f"{held / 2**30:.2f} GiB held before", flush=True)
        out[arch] = dict(layers=cfg.n_layers, params=api.num_params,
                         wall_ms=wall, loss=loss, grads_finite=finite,
                         flops=flops, bound_ms=bound_ms, peak_bytes=peak)
        del params, batch
        torch.cuda.empty_cache()
    report["g2_forward_backward"] = out


def phase_g2_parity(dev, smi: str, report: dict) -> None:
    """(n4) The card against the port's CPU at reduced() rwkv6, zamba2,
    seamless-m4t and llama-vision (:func:`_reduced_on_card`)."""
    from repro_torch.models.common import use_reference_numerics

    use_reference_numerics()
    worst = {arch: _reduced_on_card(arch, dev, "(n4)") for arch in G2_ARCHS}
    print(f"(n4) the card against the CPU, reduced configs [{smi}]: "
          + "; ".join(f"{a} loss {w['loss_card']:.6f} vs "
                      f"{w['loss_cpu']:.6f}, prefill + 4 decode logits max "
                      f"|diff| {w['logits_max_abs']:.4f}, final state/cache "
                      f"{w['state_max_abs']:.4f}" for a, w in worst.items()),
          flush=True)
    report["g2_parity"] = worst


def _held(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |diff|, max excess over atol 0.1 + rtol 0.05)."""
    diff = (got.float() - want.float()).abs()
    return (float(diff.max()),
            float((diff - 0.1 - 0.05 * want.float().abs()).max()))


def phase_g2_hybrid(dev, smi: str, report: dict) -> None:
    """(n1b) zamba2-7b's decode held to its forward at full width and depth
    block by block: every Mamba2 block and every application of the shared
    block gets the forward's own input, its decode (a prefill of the 1024
    prompt positions at the serving chunk, then 16 one-token steps) is held
    to its forward over the 1040 positions (the check's chunks) at atol
    0.1 + rtol 0.05, and the forward's output feeds the next block.  The
    logits' check of (n1) cannot hold at this depth: bf16 rounding
    differences grow ~1.2-1.5x a Mamba2 block at this init (the
    reference's own forward too), so two chunkings of the same forward
    differ at O(1) after 81 blocks -- printed here.  (n5) Then one
    full-width decode step (batch 8 at position 1056 of 1088) timed and
    profiled."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve_llm import check_config, init_serving_params
    from repro_torch.models import build, common, ssm
    from repro_torch.models.attention import KVCache
    from repro_torch.models.dense import embed

    common.use_reference_numerics()
    cfg = ARCHS["zamba2-7b"]
    api = build(cfg)
    serve = init_serving_params(api, torch.Generator(device=dev).manual_seed(0))
    b, s, n_fed = 2, G2_PROMPT, G2_CHECK
    n = s + n_fed
    fwd_cfg = check_config(cfg, n)
    tokens = torch.randint(0, cfg.vocab, (b, n), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    d_in, heads, n_state = ssm._dims(cfg)
    groups, tail = ssm._zamba_shape(cfg)
    sp = serve["shared_attn"]
    rows = []                    # (block, max |diff|, excess)

    def zero_state():
        return ssm.MambaState(None, torch.zeros(
            b, heads, n_state, cfg.ssm_head_dim, device=dev))

    def mamba(h, lp):
        want, _ = ssm.mamba_block(h, lp, fwd_cfg, zero_state())
        _, st = ssm.mamba_block(h[:, :s], lp, cfg, zero_state())
        got = []
        for j in range(s, n):
            o, st = ssm.mamba_block(h[:, j:j + 1], lp, cfg, st)
            got.append(o)
        rows.append(("mamba",) + _held(torch.cat(got, 1), want[:, s:]))
        return want

    def shared(h):
        want, _ = ssm._shared_block(h, sp, fwd_cfg, None, None, False)
        _, kv = ssm._shared_block(h[:, :s], sp, cfg, None, None, True)
        kv = KVCache(*(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n_fed))
                       for c in kv))
        got = [ssm._shared_block(h[:, j:j + 1], sp, cfg, kv, j, False)[0]
               for j in range(s, n)]
        rows.append(("shared",) + _held(torch.cat(got, 1), want[:, s:]))
        return want

    t0 = time.perf_counter()
    with torch.no_grad():
        h = embed(serve, tokens)
        for g in range(groups):
            for i in range(cfg.attn_period):
                h = mamba(h, {k: v[g, i] for k, v in serve["mamba"].items()})
            h = shared(h)
        for i in range(tail):
            h = mamba(h, {k: v[i] for k, v in serve["mamba_tail"].items()})
        prompt = tokens[:, :s]
        a = ssm.forward(serve, prompt, cfg)
        c = ssm.forward(serve, prompt, dataclasses.replace(cfg, seq_chunk=16))
        chunk_diff = float((a.float() - c.float()).abs().max())
    wall = time.perf_counter() - t0
    worst = max(r[1] for r in rows)
    excess = max(r[2] for r in rows)
    check(len(rows) == cfg.n_layers + groups and excess <= 0,
          f"(n1b) zamba2-7b decode differs from its forward block by "
          f"block: worst {worst} (excess {excess})")
    print(f"(n1b) zamba2-7b decode held to its forward block by block at "
          f"full width and depth [{smi}]: {cfg.n_layers} Mamba2 blocks and "
          f"{groups} shared-block applications, each on the forward's own "
          f"input, batch {b}, {n_fed} decode steps after a {s}-token prefill: "
          f"max |diff| {worst:.4f} (atol 0.1, rtol 0.05; worst Mamba2 "
          f"{max(r[1] for r in rows if r[0] == 'mamba'):.4f}, shared "
          f"{max(r[1] for r in rows if r[0] == 'shared'):.4f}); the logits "
          f"of one forward over the prompt at chunk 128 against chunk 16: "
          f"max |diff| {chunk_diff:.4f} (bf16 rounding grown over "
          f"{cfg.n_layers} blocks: why (n1) holds no logits check here); "
          f"{wall:.1f}s", flush=True)
    report["g2_hybrid_blocks"] = dict(blocks=len(rows), max_abs_diff=worst,
                                      chunk_logits_diff=chunk_diff)

    gen = torch.Generator(device=dev).manual_seed(2)
    state = common.tree_map(
        lambda x: (torch.randn(x.shape, generator=gen, device=dev) * 0.1
                   ).to(x.dtype) if x.dtype != torch.int32 else
        torch.full(x.shape, G2_DECODE_POS, dtype=x.dtype, device=dev),
        api.cache_specs(G2_BATCH, G2_DECODE_LEN))
    tok = torch.zeros(G2_BATCH, dtype=torch.int32, device=dev)

    def decode():
        with torch.no_grad():
            return api.decode(serve, {"token": tok, "pos": G2_DECODE_POS},
                              state)

    decode()
    reps = []
    for _ in range(5):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, _ = decode()
        torch.cuda.synchronize(dev)
        reps.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(logits.float()).all()), "(n5) zamba2 decode "
          "logits not finite")
    wall = statistics.median(reps)
    split = _kernel_split(decode, dev)
    bound = _decode_bytes(cfg, G2_BATCH, G2_DECODE_POS) / HBM_BYTES_PER_S
    _print_split(f"(n5) one zamba2-7b decode step (batch {G2_BATCH}, "
                 f"position {G2_DECODE_POS}; byte bound {bound * 1e3:.3f} "
                 f"ms)", wall, split, smi)
    report.setdefault("g2_split", {})["zamba_decode"] = dict(
        wall_ms=wall, bound_ms=bound * 1e3, **split)
    del serve, state
    torch.cuda.empty_cache()


def phase_g2(dev, smi: str, report: dict) -> None:
    """(n): (n1), (n1b) with (n5)'s zamba2 decode step, (n2), (n5)'s rwkv6
    forward + backward with (n3), (n4); with each part's wall time."""
    t0 = time.perf_counter()
    parts = {}
    for name, fn in (("n1", lambda: phase_g2_serve(smi, report)),
                     ("n1b+n5", lambda: phase_g2_hybrid(dev, smi, report)),
                     ("n2", lambda: phase_g2_train(smi, report)),
                     ("n5+n3", lambda: phase_g2_forward_backward(
                         dev, smi, report)),
                     ("n4", lambda: phase_g2_parity(dev, smi, report))):
        t1 = time.perf_counter()
        fn()
        parts[name] = time.perf_counter() - t1
    print(f"(n) phase (n) took {time.perf_counter() - t0:.3f}s ("
          + ", ".join(f"{k} {v:.1f}s" for k, v in parts.items())
          + f") [{smi}]", flush=True)


# --------------------------------------------------------------------------
# (o) the 2-D meshes: the plain step against (m2)'s one-rank mesh, and the
# dry run on the production mesh

DRY_CELLS = (("stablelm-1.6b", "train_4k"),
             ("qwen3-moe-235b-a22b", "train_4k"))
DRY_OUT = Path(__file__).resolve().parent / "build" / "dryrun"
PLAIN_STEPS = 2
# (o1): (m2)'s launcher run without the mesh -- the same config, seed,
# schedule (the launcher's for TRAIN_STEPS steps), data and numerics
PLAIN_CHILD = """
import json, sys, time
import torch
from repro_torch.configs import ARCHS
from repro_torch.data import pipeline
from repro_torch.models import build, init_params
from repro_torch.models.common import use_reference_numerics
from repro_torch.optim import adamw
from repro_torch.train import steps

arch, steps_total, seq, batch, n = sys.argv[1], *map(int, sys.argv[2:6])
dev = torch.device("cuda", 0)
use_reference_numerics()
api = build(ARCHS[arch])
opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=min(30, steps_total // 10 + 1),
                        total_steps=steps_total)
data = pipeline.DataConfig(vocab=api.cfg.vocab, seq_len=seq,
                           global_batch=batch)
state = steps.init_train_state(init_params(
    api, torch.Generator(device=dev).manual_seed(0)))
step = steps.make_train_step(api, opt)
torch.cuda.reset_peak_memory_stats(dev)
rec = {"loss": [], "grad_norm": [], "step_s": []}
for i in range(n):
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in pipeline.batch_at(data, i).items()}
    t0 = time.perf_counter()
    state, st = step(state, b)
    loss, gnorm = float(st["loss"]), float(st["grad_norm"])
    rec["step_s"].append(time.perf_counter() - t0)
    rec["loss"].append(loss)
    rec["grad_norm"].append(gnorm)
rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
print(json.dumps({"plain": rec}))
"""


def start_dryruns() -> list:
    """(o2)'s dry runs, one child process a cell, started first: they are
    host work (fake tensors, a fake process group) that runs beside the
    graph build and the card's phases."""
    import os
    import shutil
    root = Path(__file__).resolve().parent
    shutil.rmtree(DRY_OUT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    return [(arch, shape, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(DRY_OUT)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for arch, shape in DRY_CELLS]


def phase_mesh_plain(smi: str, report: dict) -> None:
    """(o1) the plain step at (m2)'s cut against (m2)'s one-rank mesh."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", PLAIN_CHILD, LLM_ARCH, str(TRAIN_STEPS),
         str(TRAIN_SEQ), str(TRAIN_BATCH), str(PLAIN_STEPS)], cwd=root,
        env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
    check(out.returncode == 0, f"(o1) plain child exited {out.returncode}")
    plain = json.loads(out.stdout.strip().splitlines()[-1])["plain"]
    mesh = report["llm_train"]
    n = PLAIN_STEPS
    same = (plain["loss"] == mesh["loss"][:n]
            and plain["grad_norm"] == mesh["grad_norm"][:n])
    print(f"(o1) {LLM_ARCH} {n} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens "
          f"[{smi}]: plain tensors losses {plain['loss']} grad norms "
          f"{plain['grad_norm']}; (m2)'s launcher on the one-rank mesh "
          f"{mesh['mesh']} (state placed by rules.param_shardings) losses "
          f"{mesh['loss'][:n]} grad norms {mesh['grad_norm'][:n]}: "
          f"{'bit for bit equal' if same else 'DIFFERENT'}", flush=True)
    check(same, "(o1) the plain step differs from (m2)'s one-rank mesh")
    mesh_ms = mesh["step_s"][1] * 1e3
    plain_ms = plain["step_s"][1] * 1e3
    print(f"(o1) step 2: plain {plain_ms:.1f} ms, one-rank mesh "
          f"{mesh_ms:.1f} ms ((m2) median after the first "
          f"{mesh['ms_per_step']:.1f} ms; DTensor's dispatch "
          f"{mesh_ms - plain_ms:+.1f} ms); first steps "
          f"{plain['step_s'][0] * 1e3:.1f} / {mesh['step_s'][0] * 1e3:.1f}"
          f" ms; peak {plain['peak_bytes'] / 2**30:.2f} / "
          f"{mesh['peak_bytes'] / 2**30:.2f} GiB; child "
          f"{time.perf_counter() - t0:.1f}s [{smi}]", flush=True)
    report["mesh_plain"] = dict(plain, mesh_ms=mesh_ms, plain_ms=plain_ms)


def phase_mesh_dryrun(procs: list, smi: str, report: dict) -> None:
    """(o2) the dry runs' records: per device on the (16, 16) mesh."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build
    res = {}
    for arch, shape, t0, proc in procs:
        out, err = proc.communicate(timeout=900)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(out[-2000:] + err[-4000:], file=sys.stderr)
        check(proc.returncode == 0,
              f"(o2) dry run of {arch} {shape} exited {proc.returncode}")
        rec = json.loads((DRY_OUT / f"{arch}__{shape}__single.json")
                         .read_text())
        mem, an = rec["memory"], rec["analyzed"]
        per_dev = mem["argument_bytes"] + mem["temp_bytes"]
        need = build(ARCHS[arch]).num_params * 16   # param, grad, m, v
        coll = ", ".join(f"{k} {v['count']} x {v['bytes'] / 1e9:.3f} GB"
                         for k, v in an["collectives"].items())
        print(f"(o2) dry run {arch} {shape} on {rec['mesh']} "
              f"({rec['n_devices']} fake ranks, fake {rec['device']} "
              f"tensors; host) per device: arguments "
              f"{mem['argument_bytes'] / 2**30:.3f} GiB, temp peak "
              f"{mem['temp_bytes'] / 2**30:.3f} GiB, outputs "
              f"{mem['output_bytes'] / 2**30:.3f} GiB; dot FLOPs "
              f"{an['dot_flops']:.4e}, eager HBM bytes "
              f"{an['hbm_bytes']:.4e}, collectives {coll} (total "
              f"{an['collective_bytes']:.4e} B); {an['n_ops']} local ops; "
              f"trace {rec['trace_s']}s, child {wall:.1f}s [{smi}]",
              flush=True)
        check(per_dev * rec["n_devices"] >= need,
              f"(o2) {arch}: per-device bytes x {rec['n_devices']} "
              f"{per_dev * rec['n_devices']:.4e} below the params, grads "
              f"and moments {need:.4e}")
        res[arch] = rec
    report["mesh_dryrun"] = res


# --------------------------------------------------------------------------
# (p) the tile autotuner: every candidate tile of K1 and K2, timed beside
# the model's cost, on a uniform, a medium and a skewed graph
# --------------------------------------------------------------------------

def chung_lu_zipf(n: int, avg_deg: int, exponent: float, seed: int):
    """A Chung-Lu graph: ``n * avg_deg / 2`` pairs, each endpoint drawn with
    probability proportional to a Zipf expected degree ``i ** (-1 / (exponent
    - 1))`` (a power-law degree tail of that exponent), the weights shuffled
    over the vertex ids; self-pairs dropped, the rest through ``from_edges``
    (parallel pairs merge, Eq. 3 weights).  Vectorized: one draw per pair."""
    from repro_torch.core.graph import from_edges

    gen = np.random.default_rng(seed)
    w = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / (exponent - 1.0))
    cdf = np.cumsum(w[gen.permutation(n)])
    cdf /= cdf[-1]
    m = n * avg_deg // 2
    src = np.searchsorted(cdf, gen.random(m), side="right")
    dst = np.searchsorted(cdf, gen.random(m), side="right")
    keep = src != dst
    return from_edges(src[keep].astype(np.int32), dst[keep].astype(np.int32),
                      n)


HOST_GRAPHS = Path(__file__).resolve().parent / "build" / "host_graphs.npz"
_GRAPH_FIELDS = ("src", "dst", "weight", "row_ptr", "deg_w")


def write_host_graphs(path: str, tenants: bool) -> None:
    """Build (p)'s skewed graph and, with ``tenants``, (k1)'s tenant graphs,
    and save their arrays (and each build's seconds) to ``path``: run in a
    child process from phase (a), so the host builds them beside the
    card's phases."""
    from repro_torch.serve import traffic

    t0 = time.perf_counter()
    graphs = {"skewed": chung_lu_zipf(SKEW_N, SKEW_DEG, SKEW_EXP, seed=5)}
    seconds = {"skewed": time.perf_counter() - t0}
    if tenants:
        t0 = time.perf_counter()
        for i in range(SERVE_TENANTS):
            graphs[f"tenant{i}"] = traffic.tenant_graph(
                SERVE_N + 17 * i, seed=i, k_nbrs=16)
        seconds["tenants"] = time.perf_counter() - t0
    arrays = {f"{name}/{f}": getattr(g, f) for name, g in graphs.items()
              for f in _GRAPH_FIELDS}
    arrays.update({f"{name}/num_vertices": g.num_vertices
                   for name, g in graphs.items()})
    arrays.update({f"seconds/{k}": v for k, v in seconds.items()})
    np.savez(path, **arrays)


def start_host_graphs(tenants: bool = True) -> subprocess.Popen:
    import os
    root = Path(__file__).resolve().parent
    HOST_GRAPHS.parent.mkdir(parents=True, exist_ok=True)
    HOST_GRAPHS.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.write_host_graphs(sys.argv[1], sys.argv[2] == '1')",
         str(HOST_GRAPHS), "1" if tenants else "0"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def load_host_graphs(proc: subprocess.Popen) -> tuple:
    """Wait for ``start_host_graphs``' child; returns ``({name: Graph},
    {name: build seconds})``."""
    from repro_torch.core.graph import Graph

    _, err = proc.communicate(timeout=900)
    check(proc.returncode == 0,
          f"the host graphs' build exited {proc.returncode}: {err[-4000:]}")
    with np.load(HOST_GRAPHS) as d:
        names = sorted({k.split("/")[0] for k in d.files} - {"seconds"})
        graphs = {n: Graph(num_vertices=int(d[f"{n}/num_vertices"]),
                           **{f: d[f"{n}/{f}"] for f in _GRAPH_FIELDS})
                  for n in names}
        seconds = {k.split("/")[1]: float(d[k]) for k in d.files
                   if k.startswith("seconds/")}
    HOST_GRAPHS.unlink()
    return graphs, seconds


def print_skewed(g, seconds: float) -> None:
    degs = np.diff(g.row_ptr)
    print(f"(p) skewed graph, built beside phases (b)-(j) in {seconds:.3f}s: "
          f"Chung-Lu, Zipf exponent {SKEW_EXP}, expected average degree "
          f"{SKEW_DEG}, V={g.num_vertices} E={g.num_directed_entries} "
          f"(average degree {degs.mean():.3f} once parallel pairs merge, "
          f"largest {degs.max()}, top 0.1% of rows "
          f"{np.sort(degs)[-SKEW_N // 1000:].sum() / degs.sum():.4f} of "
          "the entries)", flush=True)


def _fit_model(samples: list) -> dict:
    """Least squares of the model's constants on this run's times: for
    each ``parallel`` of a grid, alternate (each sample's worst slot and
    worst SM under the current constants) and a non-negative fit of the
    ``FEATURES``' seconds and the overhead to ``worst slot + worst SM /
    parallel + overhead`` on relative error; keep the ``parallel`` with
    the least error."""
    from scipy.optimize import nnls
    from repro_torch.kernels.autotune import FEATURES

    best = None
    for par in (2.0, 4.0, 8.0, 16.0, 24.0, 32.0, 48.0, 64.0):
        x = np.full(len(FEATURES), 1e-7)
        for _ in range(10):
            rows = []
            for smp in samples:
                slot = smp["slots"][int(np.argmax(smp["slots"] @ x))]
                sm = smp["sms"][int(np.argmax(smp["sms"] @ x))] / par
                rows.append(slot + sm)
            a = np.hstack([np.array(rows), np.ones((len(rows), 1))])
            t = np.array([smp["s"] for smp in samples])
            sol, _ = nnls(a / t[:, None], np.ones(len(t)))
            x = sol[:-1]
        pred = a @ sol
        err = float(np.sqrt(np.mean((pred / t - 1.0) ** 2)))
        if best is None or err < best["rms_rel_err"]:
            best = dict(zip(FEATURES, x), parallel=par, overhead=sol[-1],
                        rms_rel_err=err)
    return best


def phase_autotune(cases: list, medium, dev, smi: str, report: dict) -> None:
    """(p) For each ``(name, graph, k)`` case, K1's base form and K2 under
    every candidate tile and the default: bitwise equal to one plain run,
    CUDA-event median ms beside the model's cost and grid; the model's
    pick against the measured best; a fit of the model on these times;
    then ``partition`` of the medium graph with autotune on, off and a
    pinned tile."""
    from repro_torch import rng
    from repro_torch.core import EngineOptions, SpinnerConfig, engine
    from repro_torch.core import open_session, partition
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels.ops import CudaCsrBackend
    from repro_torch.kernels.spinner_scores import (fused_update, layout,
                                                    spinner_scores,
                                                    tile_grid)

    t_phase = time.perf_counter()
    rows, samples = [], {kernel: [] for kernel in autotune.KERNELS}
    for name, graph, k in cases:
        padded, num_real = engine.padded_view(graph,
                                              EngineOptions(device=dev))
        csr = padded.to_device(dev)
        v = padded.num_vertices
        deg = autotune._shard_degrees(padded, 1)[0]
        min_total = autotune._min_total(padded, 1)
        gen = np.random.default_rng(k + v)
        labels = torch.from_numpy(gen.integers(0, k, v, dtype=np.int32)
                                  ).to(dev)
        loads = torch.zeros(k, dtype=torch.float32, device=dev).index_add_(
            0, labels.long(), csr.deg_w)
        pen = loads / torch.tensor(1.05 * padded.total_weight / k,
                                   dtype=torch.float32, device=dev)
        noise = rng.uniform(rng.PRNGKey(k), (v, k), 0.0, 1e-7, device=dev)
        base = (labels, csr.row_ptr, csr.dst, csr.weight)
        calls = {
            "fused": lambda tile: fused_update(
                *base, csr.deg_w, pen, noise, num_real, k, 1e-6, True,
                tile=tile),
            "scores": lambda tile: spinner_scores(*base, k, tile=tile)}
        plain = {
            "fused": ref.fused_propose_ref(labels, csr.src, csr.dst,
                                           csr.weight, csr.deg_w, pen, noise,
                                           num_real, k, 1e-6, True),
            "scores": ref.spinner_scores_ref(labels, csr.src, csr.dst,
                                             csr.weight, v, k)}
        for kernel in autotune.KERNELS:
            sweep = {(r["warps"], r["rows"]): r
                     for r in autotune.sweep(padded, k, kernel=kernel)}
            pick = autotune.choose_tile_config(padded, k, kernel=kernel)
            want = plain[kernel]
            tiles = [None] + list(sweep)
            for tile in tiles:
                got = calls[kernel](tile)
                outs = got if kernel == "fused" else (got,)
                wants = want if kernel == "fused" else (want,)
                check(all(bits_equal(a, b) for a, b in zip(outs, wants)),
                      f"(p) {name} k={k} {kernel} at tile {tile} differs "
                      "from its plain version")
                del got, outs
            # three rounds over the tiles in turn, the median of each
            # tile's three medians: a drift of the card's clock or of its
            # neighbours falls on every tile alike
            rounds = [{tile: time_ms(lambda: calls[kernel](tile), reps=10)
                       for tile in tiles} for _ in range(3)]
            times = {tile: statistics.median(r[tile] for r in rounds)
                     for tile in tiles}
            default = layout(k, kernel)[:2]
            for tile, r in sweep.items():
                grid = tile_grid(kernel, v, k, tile)
                check(grid == r["grid"], f"(p) {name} k={k} {kernel} {tile}: "
                      f"the card's grid {grid}, the model's {r['grid']}")
                f = autotune.slot_features(deg, *tile, k, kernel)
                samples[kernel].append(dict(slots=f["slots"], sms=f["sms"],
                                            s=times[tile] * 1e-3))
                print(f"(p) {name} k={k} {kernel} tile {tile}"
                      f"{' (default)' if tile == default else ''}: "
                      f"{times[tile]:.4f} ms, model {r['cost_s'] * 1e3:.4f} "
                      f"ms, grid {grid}, groups {r['groups']}, largest group "
                      f"{r['max_group_entries']} entries, smem "
                      f"{r['smem_bytes']} B; bitwise equal [{smi}]",
                      flush=True)
            measured = min(sweep, key=lambda t: times[t])
            chosen = pick[:2]
            ratio = times[chosen] / times[measured]
            rows.append(dict(case=name, k=k, kernel=kernel, v=v,
                             e=padded.num_directed_entries,
                             default_ms=times[None], pick=list(chosen),
                             pick_ms=times[chosen], best=list(measured),
                             best_ms=times[measured], ratio=ratio,
                             ms={f"{w}x{r}": times[(w, r)]
                                 for w, r in sweep},
                             model_ms={f"{w}x{r}": sweep[(w, r)]["cost_s"]
                                       * 1e3 for w, r in sweep}))
            print(f"(p) {name} k={k} {kernel}: default {times[None]:.4f} ms; "
                  f"model's pick {chosen} {times[chosen]:.4f} ms, measured "
                  f"best {measured} {times[measured]:.4f} ms, pick / best "
                  f"{ratio:.4f} [{smi}]", flush=True)
        del noise, plain, calls
        torch.cuda.empty_cache()
    for kernel, smp in samples.items():
        fit = _fit_model(smp)
        report.setdefault("autotune_fit", {})[kernel] = fit
        print(f"(p) model fit on this run, {kernel} ({len(smp)} times): "
              + ", ".join(f"{key}={val:.6g}" for key, val in fit.items())
              + f"; the module's: {autotune.COEFFS[kernel]} [{smi}]",
              flush=True)

    # whole runs: the tuner on, off and a pinned non-default tile
    g = medium
    cfg = SpinnerConfig(k=K)
    res = {}
    for mode, opts in (
            ("on", EngineOptions(device=dev, autotune="on")),
            ("off", EngineOptions(device=dev, autotune="off")),
            ("pinned 4x8", EngineOptions(
                device=dev, score_backend=CudaCsrBackend(warps=4, rows=8)))):
        fused_update.launches = 0
        r = partition(g, cfg, engine="fused", options=opts)
        check(fused_update.launches == r.iterations,
              f"(p) autotune={mode}: K1 launched {fused_update.launches} "
              f"times in {r.iterations} iterations")
        with open_session(g, cfg, opts) as sess:
            tile = sess.stats()["tile_config"]
        check(list(fused_update.last_tile) == [tile["warps"], tile["rows"],
                                               tile["smem_bytes"]],
              f"(p) autotune={mode}: launched {fused_update.last_tile}, "
              f"stats say {tile}")
        res[mode] = (r, tile)
    first = res["on"][0]
    for mode, (r, tile) in res.items():
        check(np.array_equal(r.labels, first.labels)
              and np.array_equal(r.loads, first.loads)
              and r.iterations == first.iterations,
              f"(p) partition with autotune {mode} differs from 'on'")
        print(f"(p) partition(medium, autotune={mode!r}): iterations "
              f"{r.iterations}, tile_config {tile}", flush=True)
    print("(p) labels, loads and iterations identical under autotune on, "
          "off and the pinned tile", flush=True)
    took = time.perf_counter() - t_phase
    report["autotune"] = dict(cases=rows, seconds=took,
                              tile_config={m: t for m, (_, t)
                                           in res.items()})
    print(f"(p) phase (p) took {took:.3f}s [{smi}]", flush=True)


def autotune_only(host_build, dev, smi: str) -> int:
    """``python3 chip_smoke.py --autotune-only``: phase (p) alone on its
    three graphs -- the run whose printed fit refits
    ``kernels/autotune.py``'s constants after a kernel changes."""
    from repro_torch.core import generators

    graph = generators.watts_strogatz(FULL_N, DEG, BETA, seed=0)
    medium = generators.watts_strogatz(MEDIUM_N, DEG, BETA, seed=1)
    host_graphs, host_s = load_host_graphs(host_build)
    print_skewed(host_graphs["skewed"], host_s["skewed"])
    phase_autotune([("full", graph, K)]
                   + [("medium", medium, k) for k in TUNE_KS]
                   + [("skewed", host_graphs["skewed"], K)], medium, dev,
                   smi, {})
    return 0


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
            bound = r.get("bound_bytes_ms" + sfx, r["bound_ms" + sfx])
            print(f"(e) {r['name']}{sfx}: {ms:.3f} ms for {nbytes} B = "
                  f"{rate / 1e12:.3f} TB/s achieved, bound "
                  f"{bound:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
                  f"({bound / ms:.3f} of it)", flush=True)


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

    if sys.argv[1:] == ["--autotune-only"]:
        return autotune_only(start_host_graphs(tenants=False), dev, smi)
    host_build = start_host_graphs()    # (k1)'s and (p)'s graphs, built
                                        # beside the card's phases
    dryruns = start_dryruns()       # (o2): host work beside the card's
    t0 = time.perf_counter()
    graph = generators.watts_strogatz(FULL_N, DEG, BETA, seed=0)
    padded, _ = engine.padded_view(graph, engine.EngineOptions(device=dev))
    print(f"(a) host graph build {time.perf_counter() - t0:.3f}s: "
          f"V={graph.num_vertices} E={graph.num_directed_entries} padded "
          f"to ({padded.num_vertices}, {padded.num_directed_entries}); "
          f"total weight {graph.total_weight:.0f} exceeds 2^24, per-partition "
          f"loads and M(l) stay below it", flush=True)

    report: dict = {}
    phase_kernels(graph, padded, dev, report)
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
    host_graphs, host_s = load_host_graphs(host_build)
    serve_graphs = phase_serve_fleet(
        [host_graphs[f"tenant{i}"] for i in range(SERVE_TENANTS)],
        host_s["tenants"], dev, smi, report)
    torch.cuda.empty_cache()
    phase_serve_poisson(dev, smi, report)
    phase_serve_durability(serve_graphs, dev, smi, report)
    print(f"(k) phase (k) took {time.perf_counter() - t0:.3f}s [{smi}]",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_cluster_workers(graph, dev, smi, report)
    torch.cuda.empty_cache()
    phase_cluster_supervisor(graph, medium, dev, smi, report)
    phase_cluster_deployment(serve_graphs, dev, smi, report)
    print(f"(l) phase (l) took {time.perf_counter() - t0:.3f}s [{smi}]",
          flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB (phases (b)-(l))", flush=True)
    torch.cuda.empty_cache()
    phase_llm(dev, smi, report)
    torch.cuda.empty_cache()
    phase_g2(dev, smi, report)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_mesh_plain(smi, report)
    phase_mesh_dryrun(dryruns, smi, report)
    print(f"(o) phase (o) took {time.perf_counter() - t0:.3f}s (the dry "
          f"runs started with phase (a)) [{smi}]", flush=True)
    torch.cuda.empty_cache()
    print_skewed(host_graphs["skewed"], host_s["skewed"])
    phase_autotune([("full", graph, K)]
                   + [("medium", medium[0], k) for k in TUNE_KS]
                   + [("skewed", host_graphs["skewed"], K)], medium[0], dev,
                   smi, report)

    tpu = "src/repro/kernels/spinner_scores.py"
    replaces = {"fused_update_csr": f"{tpu}:241",
                "spinner_scores_csr": f"{tpu}:100"}
    kernels = [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": replaces[name], "launches": r["launches"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": r["library_ms"],
        "tile": r["tile"],
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
        "tile": front["tile"],
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
        "tile": seeded["tile"],
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
    draws = report["threefry_uniform"]
    kernels.append({
        "name": "threefry_uniform", "route": "cuda",
        "source": THREEFRY_SOURCE,
        "replaces": "none (jax.random.uniform in XLA, "
                    "src/repro/core/engine.py:593-595)",
        "launches": draws["launches"],
        "max_abs_err": max(draws["max_abs_err"],
                           draws["random_keys"]["max_abs_err"]),
        "ms": draws["ms"], "plain_ms": draws["plain_ms"],
        "bound_ms": draws["bound_ms"], "bound_by": "instructions",
        "bound_bytes_ms": draws["bound_bytes_ms"], "bytes": draws["bytes"],
        "library_ms": None, "noise_ms": draws["noise_ms"],
        "u_ms": draws["u_ms"], "outputs": draws["outputs"],
        "alu_instructions": draws["alu_instructions"], "sms": draws["sms"],
        "clock_max_mhz": draws["clock_max_mhz"],
        "ms_random_keys": draws["random_keys"]["ms"],
        "plain_ms_random_keys": draws["random_keys"]["plain_ms"]})
    for r in kernels:
        if r["name"] in ("spinner_scores_csr", "fused_update_csr"):
            r["bytes"] = report[r["name"]]["bytes"]
        if r["name"] == "fused_update_csr":
            # (k): the CUDA-backend fleet's serial K1 path, and the replay
            r["launches_serve_fleet"] = report["serve_fleet"]["cuda"][
                "k1_launches"]
            r["launches_serve_poisson"] = report["serve_poisson"][
                "k1_launches"]
            # (l2), (l3): the supervised sessions and the deployment
            r["launches_cluster_supervisor"] = sum(
                x["k1_launches"]
                for x in report["cluster_supervisor"].values())
            r["launches_cluster_deployment"] = report["cluster_deployment"][
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
                  "interior_launches"],
              # (l1): every cluster worker's supersteps, one launch each
              launches_cluster_worker=report["cluster_workers"][
                  "k2_launches"],
              **{f"{key}_cluster_worker_rows": report["cluster_workers"][
                  "k2_rows"][key] for key in ("ms", "plain_ms",
                                              "bound_ms")})
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
