"""The tiny cells on the card, held to the reference there (skip without
a CUDA card; run on the card with ``python -m pytest -m gpu
portbench/tests``)."""
import pytest
import torch

from portbench.harness import spec

CELLS = [w["name"] for w in spec.bench()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_the_card(run_tiny, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, checks = run_tiny(cell, device=torch.device("cuda", 0))
    assert result["correct"], checks
    assert result["device"]["memory_peak_bytes"] > 0
