"""The metrics that read the program's own spans
(``repro_torch.runtime.trace``), on the tiny cells on the CPU.

``run_cell(..., trace_on=True)`` needs a card (it synchronises one), so
these drive a cell's kind by hand: its set-up, then its traced calls
inside ``trace.recording()``, with ``run.traced`` filled from them.
"""
import pytest

from portbench import graphs
from portbench.harness import cell as cell_mod
from portbench.harness import spec
from portbench.harness.systems import PortSystem
from portbench.harness.traffic import Traffic
from portbench.reference import spinner as ref
from portbench.tests.conftest import BIG_SEED, tiny

from repro_torch.runtime import trace

BENCH = spec.bench()
NEW = {"epilogue_ms.partition": "ws4m-k32.partition",
       "ledger_ms.adapt": "ws4m-k32.adapt",
       "merge_ms.adapt": "ws4m-k32.adapt",
       "restart_ms.adapt": "ws4m-k32.adapt",
       "readback_ms.adapt": "ws4m-k32.adapt"}
DEVICE = {"epilogue_ms.partition"}          # device ms: None on the CPU


def _driven(cell: str, traced: bool):
    """A ``Run`` of the tiny ``cell`` after its set-up and, if ``traced``,
    its traced calls made inside ``trace.recording()``."""
    config, mix = tiny(cell)
    kind = spec.kind(mix["kind"])
    seeds = cell_mod.Seeds(BIG_SEED)
    graph = graphs.build(config["graph"], int(config["graph"]["seed"]),
                         "cpu")
    k = ref.Params.from_config(config["spinner"]).k
    traffic = Traffic(mix, graph, k, seeds.traffic, "cpu")
    run = cell_mod.Run(config=config, traffic=traffic, device="cpu",
                       sample_seed=seeds.sample)
    system = PortSystem(graph, config, seeds.spinner, "cpu",
                        traffic.init_labels(-1))
    j = kind.setup(run, system)
    if traced:
        with trace.recording():
            for i in range(int(mix.get("traced_calls", 1))):
                run.traced.append(kind.call(run, system, j + i, False))
    system.close()
    return run


@pytest.fixture(scope="module")
def runs():
    trace.reset()
    out = {c: _driven(c, True) for c in sorted(set(NEW.values()))}
    yield out
    trace.reset()


def test_the_new_metrics_are_in_the_benchmark():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name, cell in NEW.items():
        m = entries[name]
        assert m["workloads"] == [cell]
        assert m["source"] == "program_counter"
        assert (m["unit"], m["better"]) == ("ms", "lower")
        assert name in spec.metrics_for(BENCH, cell, "per_layer")


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_found_by_name(name):
    mod = spec.metric(name)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["layer"], entry["moves"])


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_reads_the_traced_calls(runs, name):
    run = runs[NEW[name]]
    assert run.traced
    value = spec.metric(name).read(run)
    if name in DEVICE:
        assert value is None
    else:
        assert value is not None and value > 0


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_without_traced_calls_reads_nothing(runs, name):
    run = _driven(NEW[name], False)
    assert not run.traced
    assert spec.metric(name).read(run) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_without_records_reads_nothing(runs, name):
    saved = trace.records()
    trace.reset()
    try:
        assert spec.metric(name).read(runs[NEW[name]]) is None
    finally:
        trace._ring.extend(saved)


def test_adapt_readers_take_only_the_traced_calls(runs):
    """Records of earlier calls (here: the same calls again, untraced by
    the run) are left out: the last ``len(run.traced)`` roots count."""
    run = runs["ws4m-k32.adapt"]
    recs = trace.records()
    adapts = [r for r in recs if r.name == "session.adapt"]
    assert len(adapts) == len(run.traced)
    ledger = sum(r.host_ms for r in recs if r.name == "delta.ledger")
    got = spec.metric("ledger_ms.adapt").read(run)
    assert got == pytest.approx(ledger / len(adapts))
    one = type(run)(config=run.config, traffic=run.traffic,
                    device=run.device, sample_seed=run.sample_seed,
                    traced=run.traced[-1:])
    last = adapts[-1].call
    want = sum(r.host_ms for r in recs
               if r.name == "delta.ledger" and r.call == last)
    assert spec.metric("ledger_ms.adapt").read(one) == pytest.approx(want)
