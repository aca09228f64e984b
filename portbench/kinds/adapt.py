"""Kind ``adapt``: batches of new edges into one session, re-converged.

Set-up partitions once to the halt and adapts once (the warm batch 0);
the window then sends batches ``1, 2, ...`` (``Traffic.batch``) to
``adapt(edge_updates=batch)``, the dense restart from the last labels
(Section 3.4).  A call that leaves the delta fast path raises: the mix is
sized (``max_batches``) to fit the edge bucket's slack, so a fallback
would time a host rebuild instead.

The check is a chain: the reference recomputes adapt ``j`` from the
labels the program gave at ``j - 1`` and the merged graph it works out
itself (its own pair ledger); the chain's start, the set-up partition,
from its own initial labels.
"""
from __future__ import annotations

import sys

import torch

from portbench.kinds import entry, partition, span, timed
from portbench.reference import spinner as ref

KIND = "adapt"


def answer(system, src, dst) -> ref.Answer:
    return entry(sys.modules[__name__], system)(system, src, dst)


def on_port(system, src, dst) -> ref.Answer:
    return system.answer(system.session.adapt(edge_updates=(src, dst)))


def on_control(system, src, dst) -> ref.Answer:
    ledger = system.state.get("ledger")
    if ledger is None:
        e = system.edges
        ledger = system.state["ledger"] = ref.PairLedger(
            e.src, e.dst, e.w, e.num_vertices)
    ledger.add(torch.from_numpy(src).to(system.device),
               torch.from_numpy(dst).to(system.device))
    total = ledger.total_weight(system.base_total)
    ans = ref.run(ledger.edges(), system.params,
                  torch.from_numpy(system.state["labels"]),
                  ref.capacity(system.params, total), system.seed,
                  system.dtype)
    system.state["labels"] = ans.labels
    return ans


def fast_path_held(system) -> dict:
    """The system's counters, after raising if an adapt left the delta
    fast path."""
    st = system.stats()
    fallbacks = st.get("fallback_adapts", 0)
    rebuilds = st.get("host_rebuilds", 0)
    if fallbacks or rebuilds:
        raise RuntimeError("an adapt left the delta fast path (fallbacks "
                           f"{fallbacks}, host rebuilds {rebuilds})")
    return st


def setup(run, system) -> int:
    t = run.traffic
    run.setup.append(partition.answer(system, t.init_labels(0)))
    run.setup.append(answer(system, *t.batch(0)))
    fast_path_held(system)
    return 1


def call(run, system, j: int, traced: bool) -> dict:
    with span("batch_gen", traced):
        src, dst = run.traffic.batch(j)
    with span("adapt", traced):
        ans, seconds = timed(run.device, answer, system, src, dst)
    st = fast_path_held(system)
    return {"kind": KIND, "input": j, "seconds": seconds,
            "iterations": ans.iterations, "answer": ans,
            "upload_bytes": st.get("last_upload_bytes", 0)}


def check(run, judge, picked: list) -> None:
    t = run.traffic
    # the set-up partition, the warm adapt, then the window's adapts
    chain = run.setup + [c["answer"] for c in run.window]
    judge.against(chain[0], judge.edges, t.init_labels(0), judge.base_total)
    e = judge.edges
    ledger = ref.PairLedger(e.src, e.dst, e.w, e.num_vertices)
    judge.edges = e = None
    due = set(picked)
    for j, b in enumerate([0] + [c["input"] for c in run.window]):
        src, dst = t.batch(b)
        ledger.add(torch.from_numpy(src).to(judge.device),
                   torch.from_numpy(dst).to(judge.device))
        if j - 1 in due:
            judge.against(chain[j + 1], ledger.edges(), chain[j].labels,
                          ledger.total_weight(judge.base_total))
