"""The port's graph examples (``examples/torch_*.py``, the counterparts of
``quickstart.py``, ``partition_and_analyze.py`` and ``elastic_resize.py``)
run to their end on the CPU at a small size, printing what their
reference examples print."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "torch_quickstart": ("converged in", "phi =", "session: bucket=",
                         "adapt after 500 new edges", "resize 16 -> 20"),
    "torch_partition_and_analyze": ("pagerank", "sssp", "wcc",
                                    "+1% edges: adapted"),
    "torch_elastic_resize": ("initial k=16", "4 nodes join: k=16 -> 20",
                             "8 nodes preempted: k=20 -> 12"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_small_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / f"{name}.py"),
         "--device", "cpu", "--n", "1500"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    for text in EXAMPLES[name]:
        assert text in out.stdout, (text, out.stdout)
    assert "graph: 1500 vertices" in out.stdout
