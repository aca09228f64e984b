"""The port has every public name of the JAX package.

Each module under ``src/repro/`` is parsed with ``ast``, never imported:
its public top-level functions, classes and constants, and the public
methods of its public classes.  The counterpart module under
``src/repro_torch/`` is imported and must have each name (``hasattr``, so
a re-export counts), except the names in ``TPU_ONLY``: each is tied to the
TPU's layout or to XLA compilation, and its reason says what the port does
instead.  A method of an exempt class is exempt with it.  The list cannot
rot: each of its names must still be in the reference and still absent
from the port.

The reference's four ``pl.pallas_call`` sites are counted too: each
site's launcher is in ``TPU_ONLY``, and its reason names the CUDA entry
points of its port under ``src/repro_torch/kernels/csrc/``.
"""
import ast
import glob
import importlib
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro")
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")

_SPECS = ("shard_map in_specs of the plan's operands; the port's plans run "
          "on each rank's tensors over a process group and take no specs")
_COMPILES = ("jit cache growth; eager PyTorch compiles nothing, the port "
             "counts uploads() instead")
_TILED = ("the MXU tiled layout the one-hot Pallas kernels read; the port's "
          "kernels read Graph's CSR")
_HLO = ("parses XLA's HLO text; the port's launch.hlo_analysis.OpAnalysis "
        "records the ops as they dispatch")

TPU_ONLY = {
    "core/comm.py": {
        "ExchangePlan.arg_specs": _SPECS,
        "HaloPlan.arg_specs": _SPECS,
        "HaloDeltaPlan.arg_specs": _SPECS,
    },
    "core/delta.py": {
        "BATCH_FLOOR": "the smallest bucket a batch is padded to, so XLA "
                       "compiles one merge a bucket; the port merges a "
                       "batch eagerly at its own length",
        "init_single_xla": "the XLA backend's padded COO slack; the port's "
                           "is init_single_csr",
        "init_single_pallas": "slack in the Pallas TiledCSR layout; the "
                              "port's is init_single_csr",
        "init_sharded_xla": "the shard_map layout's slack; the port's is "
                            "init_sharded_csr",
    },
    "core/engine.py": {
        "Program": "a jit program and its XLA cache identity; the port's "
                   "runners are eager closures (make_fused_runner)",
        "device_edges": "the XLA backend's COO upload; the port's is "
                        "Graph.to_device's CSR",
        "cached_jit_step": "a jitted step on exact shapes; the port's is "
                           "make_step",
        "make_iteration": "a jitted iteration on exact shapes; the port's "
                          "is make_iterate with make_bind",
        "make_step_fn": "a jitted state step on exact shapes; the port's "
                        "is make_step",
        "make_chunked_runner": "a lax.scan of chunk_size iterations; the "
                               "port's chunk loop is run_chunked",
        "state_partition_spec": "shard_map specs of SpinnerState; the "
                                "port's state lives on each rank",
    },
    "core/graph.py": {
        "TiledCSR": _TILED,
        "ShardedTiledCSR": _TILED,
        "build_tiled_csr": _TILED,
        "build_sharded_tiled_csr": _TILED,
        "round_robin_perm": "the degree-balanced row order of the MXU tiles; "
                            "the CUDA kernels balance by row groups",
    },
    "core/session.py": {"PartitionSession.compiles": _COMPILES},
    "serve/scheduler.py": {"PartitionScheduler.compiles": _COMPILES},
    "kernels/autotune.py": {
        name: "the TPU v5e cost model; the port's model is the H100's "
              "(COEFFS, fitted on the card)"
        for name in ("HBM_BW", "PEAK_FLOPS", "GRID_STEP_OVERHEAD_S")},
    "kernels/ops.py": {
        "round_up": "pads k to the TPU's 128 lanes; the port's round_up is "
                    "in kernels/autotune.py",
        "spinner_scores_tiled": "K2 through the tiled layout; the port's K2 "
                                "is kernels.spinner_scores.spinner_scores",
        "ScoreBackend": "the Protocol of jit closures keyed for XLA's "
                        "program cache; the port's backends are eager",
        "XlaScatterBackend": "XLA's scatter-add; the port's is "
                             "TorchScatterBackend",
        "PallasTiledBackend": "the Pallas kernels over TiledCSR; the port's "
                              "is CudaCsrBackend",
    },
    "kernels/pregel_combine.py": {
        "pregel_reduce_pallas": "K3's Pallas launcher; the port's K3 is "
                                "pregel_reduce_sum_csr and "
                                "pregel_reduce_min_csr "
                                "(kernels.pregel_combine.pregel_reduce)",
        "pregel_combine_pallas": "K4's Pallas launcher; the port's K4 is "
                                 "pregel_combine_sum_csr and "
                                 "pregel_combine_min_csr "
                                 "(kernels.pregel_combine.pregel_combine)",
        "combine_tiles_interior": "K3 over the TiledCSR layout; the port's "
                                  "is kernels.pregel_combine.pregel_reduce",
        "combine_tiles_finish": "K4 over the TiledCSR layout; the port's is "
                                "kernels.pregel_combine.pregel_combine",
    },
    "kernels/ref.py": {
        "spinner_scores_tiled_ref": "the oracle on the TiledCSR layout; the "
                                    "port's is spinner_scores_ref",
    },
    "kernels/spinner_scores.py": {
        "spinner_scores_pallas": "K2's Pallas launcher; the port's K2 is "
                                 "spinner_scores_csr "
                                 "(kernels.spinner_scores.spinner_scores)",
        "fused_update_pallas": "K1's Pallas launcher; the port's K1 is "
                               "fused_update_csr, "
                               "fused_update_frontier_csr and "
                               "fused_update_seeded_csr "
                               "(kernels.spinner_scores.fused_update*)",
        "scores_from_tiles": "K2 over a tiling, un-permuted; the port's is "
                             "kernels.spinner_scores.spinner_scores",
        "fused_update_from_tiles": "K1 over a tiling, in vertex order; the "
                                   "port's is "
                                   "kernels.spinner_scores.fused_update",
    },
    "launch/dryrun.py": {"collective_stats": _HLO},
    "launch/hlo_analysis.py": {
        name: _HLO for name in ("COLLECTIVES", "Instr", "analyze",
                                "parse_module", "type_bytes")},
}


def _modules():
    return sorted(os.path.relpath(p, REF).replace(os.sep, "/")
                  for p in glob.glob(os.path.join(REF, "**", "*.py"),
                                     recursive=True))


def _tree(rel: str) -> ast.Module:
    with open(os.path.join(REF, rel)) as f:
        return ast.parse(f.read())


def _public(rel: str) -> list:
    """Public top-level functions, classes and constants of a reference
    module, and ``Class.method`` for each public method of a public
    class."""
    names = []
    for node in _tree(rel).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{b.name}" for b in node.body
                          if isinstance(b, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and not b.name.startswith("_")]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names += [n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name) and not n.id.startswith("_")]
    return names


def _port(rel: str):
    mod = "repro_torch." + rel[:-len(".py")].replace("/", ".")
    return importlib.import_module(mod.removesuffix(".__init__"))


def _has(module, dotted: str) -> bool:
    obj = module
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("rel", _modules())
def test_port_has_every_public_name(rel):
    exempt = TPU_ONLY.get(rel, {})
    port = _port(rel)
    names = _public(rel)
    for name, reason in exempt.items():
        assert name in names, f"{rel}: {name} left the reference"
        assert not _has(port, name), f"{rel}: the port now has {name}"
        assert reason
    missing = [n for n in names
               if n not in exempt and n.split(".")[0] not in exempt
               and not _has(port, n)]
    assert missing == [], f"repro_torch lacks {missing} of repro/{rel}"


def test_every_pallas_call_launcher_names_its_port():
    csrc = ""
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        with open(path) as f:
            csrc += f.read()
    entry_points = set(re.findall(r'extern "C" int (\w+)\(', csrc))
    sites = []
    for rel in _modules():
        for fn in _tree(rel).body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            sites += [(rel, fn.name, node.lineno) for node in ast.walk(fn)
                      if isinstance(node, ast.Attribute)
                      and node.attr == "pallas_call"]
    assert len(sites) == 4, sites
    for rel, launcher, line in sites:
        reason = TPU_ONLY.get(rel, {}).get(launcher)
        assert reason, f"{rel}:{line} {launcher} is not in TPU_ONLY"
        ports = re.findall(r"\b\w+_csr\b", reason)
        assert ports, f"{launcher}'s reason names no CUDA entry point"
        assert set(ports) <= entry_points, (launcher, ports)
