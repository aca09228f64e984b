"""The port's rwkv (rwkv6-1.6b) and hybrid (zamba2-7b) families against
the reference's on the CPU: whole reduced models on carried weights (the
init's and ``torch_g2.strengthened``'s, ``remat`` on and off) -- the loss
(rel 1e-3) and its gradients, the prefill logits and cache or state,
four decode steps and the final cache or state (atol 5e-2) -- and three
train steps against the reference's ``train_step`` (losses rtol 5e-3).
The shared pieces are in ``tests/torch_g2.py``.
"""
import pytest
import torch

from torch_g2 import (WEIGHTS_REMAT, check_matches_reference,
                      check_train_steps)

ARCHS = ["rwkv6-1.6b", "zamba2-7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs six
    workers on the CPU, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("weights,remat", WEIGHTS_REMAT)
def test_family_matches_reference(arch, weights, remat):
    check_matches_reference(arch, weights, remat)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    check_train_steps(arch)
