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
FULL_N, MEDIUM_N, DEG, BETA, K = 4_000_000, 200_000, 16, 0.3, 32
SPLIT_ITERS = 8                    # depth of the score-matrix path run
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/spinner_scores.cu"


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


def phase_main_path(graph, padded, dev, report: dict) -> None:
    """(c) The main path at full size, through the fused kernel."""
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


def phase_medium_parity(dev, report: dict) -> None:
    """(d) Backends and fused/split paths agree label for label."""
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
    phase_main_path(graph, padded, dev, report)
    torch.cuda.empty_cache()
    phase_medium_parity(dev, report)
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
