"""The device trace of a ``--trace 1`` run, reduced to what metrics read.

``capture`` runs a function under ``torch.profiler`` (host and CUDA
activity) inside a ``trace_window`` span, writes the Chrome trace to a
file under the checkout's ``build/``, reduces it and deletes it.
``reduce`` works on the trace's events alone:

* ``window_s``: the ``trace_window`` span's length;
* ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the window;
* ``kernels``: seconds and launches by kernel name;
* ``span_device_s``: the device seconds of the work launched inside each
  benchmark span, by the innermost span around its launch (the runtime
  call with the same ``correlation``);
* ``gaps``: the idle intervals between device work, each named by the
  innermost benchmark span the host was in at the gap's middle
  (``partition``, ``adapt``, ``batch_gen``, ``init_gen``, ``draws``;
  ``host`` outside them).

The program has no spans of its own yet, so ``program_spans`` wraps the
functions named in ``PROGRAM_SPANS`` in a span of the benchmark's while
the traced calls run: ``draws`` is the time the runner spends in its
threefry draws.  A function the program no longer calls leaves its span
empty, and the metric that reads it finds nothing.
"""
from __future__ import annotations

import importlib
import json
import os
from contextlib import contextmanager
from functools import wraps
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("partition", "adapt", "batch_gen", "init_gen", "draws")
WINDOW = "trace_window"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# span -> (module of the program, its functions the span wraps)
PROGRAM_SPANS = {"draws": ("repro_torch.rng", ("uniform", "uniform_many"))}


@contextmanager
def program_spans(on: bool = True):
    """For the block, each function of ``PROGRAM_SPANS`` runs inside its
    span; the module's own attributes are put back after it."""
    from torch.profiler import record_function

    saved = []

    def spanned(name, fn):
        @wraps(fn)
        def inner(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return inner

    try:
        for name, (module, fns) in (PROGRAM_SPANS.items() if on else ()):
            mod = importlib.import_module(module)
            for fn in fns:
                if hasattr(mod, fn):
                    saved.append((mod, fn, getattr(mod, fn)))
                    setattr(mod, fn, spanned(name, getattr(mod, fn)))
        yield
    finally:
        for mod, fn, orig in reversed(saved):
            setattr(mod, fn, orig)


def capture(fn, path: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list) -> dict:
    """The window's busy time, kernels by name and idle gaps (seconds)."""
    window = [e for e in events if e.get("ph") == "X"
              and e.get("name") == WINDOW and e.get("cat") != "gpu_user_annotation"]
    if not window:
        raise ValueError("the trace has no trace_window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device, kernels, spans, launched = [], {}, [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, a = e.get("cat"), float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            device.append((a, b, e.get("args", {}).get("correlation")))
            if cat == "kernel":
                s, n = kernels.get(e["name"], (0.0, 0))
                kernels[e["name"]] = (s + (b - a) * 1e-6, n + 1)
        elif cat == "user_annotation" and e.get("name") in SPANS:
            spans.append((a, b, e["name"]))
        elif cat in RUNTIME_CATS and "correlation" in e.get("args", {}):
            launched[e["args"]["correlation"]] = a

    def innermost(t):
        inner = [s for s in spans if s[0] <= t < s[1]]
        return min(inner, key=lambda s: s[1] - s[0])[2] if inner else None

    span_device = {}
    for a, b, corr in device:
        name = innermost(launched[corr]) if corr in launched else None
        if name is not None:
            span_device[name] = span_device.get(name, 0.0) + (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _ in device])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((innermost((a + b) / 2) or "host", (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": kernels, "span_device_s": span_device, "gaps": gaps}


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[name[:120], s] for name, (s, _) in ops],
            "idle_gaps": [[name, s] for name, s in summary["gaps"][:top]]}
