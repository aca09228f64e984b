"""Checkpoint/restart supervision of a training loop (``failures``)."""
from . import failures
from .failures import SupervisorConfig, TrainSupervisor

__all__ = ["failures", "SupervisorConfig", "TrainSupervisor"]
