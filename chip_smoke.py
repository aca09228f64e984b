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
      give the same labels, loads and iteration counts;
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
  (e) one JSON line describing each kernel.

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
    print(f"(d) medium parity V={MEDIUM_N}: cuda/on, cuda/off and torch/off "
          f"identical ({base.iterations} iterations)", flush=True)
    return g, base.labels


def hash_labels(v: int, k: int) -> np.ndarray:
    """The hash placement baseline (vertex id times Knuth's constant)."""
    return (np.arange(v, dtype=np.int64) * 2654435761 % k).astype(np.int32)


def pregel_bound(rp, dst, combine: str, seeded: bool, update: bool) -> dict:
    """The least time of one combine-kernel call on this CSR: the bytes
    it must move (row_ptr 8 B/row, dst 4 B/edge, the send vector once --
    not read at all when there are no edges --, the seed, and for the
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
    nbytes = fixed + (rows * 4 if edges else 0)
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
        step = make_superstep(spec, lay, *COMBINE_BACKENDS["cuda"], 0.85)
        values = torch.from_numpy(init_values(spec, lay)).to(dev)
        changed = torch.from_numpy(init_active(spec, lay)).to(dev)
        state = AppState(values=values, changed=changed, step=0,
                         active=int(changed.sum()),
                         msgs=torch.zeros((), device=dev))
        parts = {"superstep_ms": time_ms(lambda: step(state), reps=20),
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
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
    torch.cuda.empty_cache()
    phase_apps(graph, labels, dev, report)
    phase_apps_medium(*medium, dev)
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
