"""What the harness loads: never JAX, never the JAX package; the
reference nothing of the program; nothing reads the JAX benchmark."""
import ast
import subprocess
import sys

import pytest

from portbench.harness import spec

HERE = spec.HERE
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=spec.ROOT,
        env={"PYTHONPATH": f"{spec.ROOT}:{spec.ROOT / 'src'}",
             "PATH": "/usr/bin:/bin"})
    return set(out.stdout.split())


def test_harness_loads_neither_jax_nor_the_jax_package():
    mods = ["portbench.harness.cell", "portbench.harness.systems",
            "portbench.graphs.watts_strogatz", "portbench.graphs.chung_lu",
            "repro_torch.core", "repro_torch.core.session"]
    code = "\n".join(f"import {m}" for m in mods)
    code += ("\nfrom portbench.harness import spec\n"
             "[spec.metric(m['name']) for k in ('end_to_end', 'per_layer')"
             " for m in spec.bench()[k]]\n"
             "import runpy; runpy.run_path('portbench/run.py')\n"
             "runpy.run_path('portbench/control.py')")
    loaded = _loaded(code)
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & BANNED


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import portbench.reference.spinner")
    assert not loaded & (BANNED | {"repro_torch"})


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_imports_by_top_level_name(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & BANNED
    if "reference" in path.parts:
        assert names <= {"__future__", "dataclasses", "typing", "numpy",
                         "torch"}
    assert "benchmarks" not in path.read_text()
