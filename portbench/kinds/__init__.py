"""Kinds of traffic: what a mix's calls do, found by name.

A mix names its kind (``"kind"`` in ``traffic/<name>.json``), and
``kinds/<kind>.py`` holds everything of that kind of call:

* ``setup(run, system) -> int``: the work before the window that the
  traffic needs (its answers kept in ``run.setup``); returns the index of
  the window's first input;
* ``call(run, system, j, traced) -> dict``: one timed call on input
  ``j``: ``{"kind", "input", "seconds", "iterations", "answer", ...}``;
* ``check(run, judge, picked)``: its part of the comparison: hands the
  window's answers ``picked`` (indices into ``run.window``), and whatever
  set-up kept, to ``judge.against`` with the inputs the reference needs;
* ``on_port(system, ...)`` and ``on_control(system, ...)``: the entry the
  call makes on the program and on the control in its place.

A new kind is a new file and mixes that name it; nothing here changes.
"""
from __future__ import annotations

import importlib
import time
from contextlib import nullcontext

import torch


def load(name: str):
    """The kind module ``kinds/<name>.py``."""
    if not name.isidentifier():
        raise ValueError(f"bad traffic kind {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def entry(module, system):
    """``module``'s entry on ``system`` (``on_port`` or ``on_control``)."""
    return getattr(module, "on_" + system.name)


def span(name: str, on: bool):
    if on:
        from torch.profiler import record_function
        return record_function(name)
    return nullcontext()


def timed(device, fn, *args) -> tuple:
    """``(fn(*args), seconds)``, the device synchronised before the clock
    stops."""
    t0 = time.perf_counter()
    out = fn(*args)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0
