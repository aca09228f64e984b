"""Fault tolerance: checkpoint/restart orchestration + failure policy.

The port of the reference's ``repro.runtime.failures``, on the port's
checkpoints (``repro_torch.ckpt``).  The policy is the synchronous-SPMD
one:

  1. checkpoint atomically every N steps;
  2. on any failure restart from the newest complete checkpoint; a step
     whose data is a pure function of (seed, step) needs no data-state
     recovery, so the restart is bit-exact;
  3. stragglers: a step slower than ``straggler_factor`` x the running
     median is flagged for replacement.

``TrainSupervisor`` packages (1)-(3) for a training loop whose state is a
tree of tensors (``checkpoint.restore`` puts each leaf back on the
device of the initial state's leaf).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..ckpt import checkpoint


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    keep: int = 3
    straggler_factor: float = 3.0      # flag steps slower than 3x median


class TrainSupervisor:
    """Wraps a train loop with checkpointing + straggler detection."""

    def __init__(self, cfg: SupervisorConfig, state):
        self.cfg = cfg
        self.state = state
        self.step_times = []
        self.flagged_steps = []
        start = checkpoint.latest_step(cfg.ckpt_dir)
        self.start_step = 0
        if start is not None:
            self.state = checkpoint.restore(cfg.ckpt_dir, state)
            self.start_step = start

    def run(self, train_step: Callable, batch_fn: Callable, num_steps: int,
            crash_at: Optional[int] = None):
        """Run to num_steps; ``crash_at`` simulates a mid-run failure."""
        step = self.start_step
        while step < num_steps:
            if crash_at is not None and step == crash_at:
                raise RuntimeError(f"simulated worker failure at {step}")
            t0 = time.time()
            self.state, stats = train_step(self.state, batch_fn(step))
            dt = time.time() - t0
            self.step_times.append(dt)
            med = sorted(self.step_times)[len(self.step_times) // 2]
            if dt > self.cfg.straggler_factor * med and len(
                    self.step_times) > 5:
                self.flagged_steps.append((step, dt, med))
            step += 1
            if step % self.cfg.ckpt_every == 0:
                checkpoint.save(self.cfg.ckpt_dir, step, self.state)
                checkpoint.gc_old(self.cfg.ckpt_dir, keep=self.cfg.keep)
        checkpoint.save(self.cfg.ckpt_dir, step, self.state)
        return self.state

    def stats(self) -> dict:
        """Straggler-watchdog report: ``flagged_steps`` is the list of
        ``(step, dt, median)`` walltime outliers (> ``straggler_factor``
        x the running median)."""
        times = sorted(self.step_times)
        return {
            "steps": len(self.step_times),
            "start_step": self.start_step,
            "median_step_time": times[len(times) // 2] if times else None,
            "straggler_factor": self.cfg.straggler_factor,
            "flagged_steps": list(self.flagged_steps),
        }
