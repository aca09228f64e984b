"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration ``<name>``: ``portbench/configs/<name>.json``;
* a traffic mix ``<name>``: ``portbench/traffic/<name>.json``, data
  naming its ``kind``;
* a traffic kind ``<kind>``: ``portbench/kinds/<kind>.py``, the calls of
  that kind, their set-up and their part of the check;
* a metric ``<name>``: ``portbench/metrics/<name>.py``, a module with
  ``UNIT``, ``LAYER``, ``MOVES`` and ``read(ctx) -> float | None``.

A new cell, mix, kind or metric is new files and new entries in
``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # portbench/
ROOT = HERE.parent                               # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def bench(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   + ", ".join(w["name"] for w in spec["workloads"]))


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{_checked(name)}.json")
                      .read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{_checked(name)}.json")
                      .read_text())


def kind(name: str):
    """The module of traffic kind ``name``."""
    from ..kinds import load
    return load(_checked(name))


def metric(name: str):
    """The reader module of metric ``name``."""
    path = HERE / "metrics" / f"{_checked(name)}.py"
    mod_name = "portbench_metric_" + re.sub(r"\W", "_", name)
    loader = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod


def metrics_for(spec: dict, cell: str, kind: str) -> list:
    """The names of the ``kind`` metrics (``end_to_end`` or ``per_layer``)
    that cell ``cell`` reports: those without a ``workloads`` list and
    those whose list names the cell."""
    return [m["name"] for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]
