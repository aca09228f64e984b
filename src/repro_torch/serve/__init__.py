"""repro_torch.serve: the multi-tenant partition serving tier.

Spinner's § dynamicity positions partitioning as a continuously running
cloud service.  This package is that service, the port of
``repro.serve``: a :class:`~repro_torch.serve.scheduler.PartitionScheduler`
holds many independent graphs (one
:class:`~repro_torch.core.session.PartitionSession` each) and drains a
stream of ``partition`` / ``edge_updates`` / ``adapt`` / ``resize``
requests through per-tenant delta coalescing
(``repro_torch.core.delta.coalesce_updates``: one merge per window),
same-bucket batched execution (``repro_torch.core.engine.run_batched``:
one batched run for every torch-backend tenant in a shape bucket,
bit-identical per tenant to its own serial adapt) and prefetch policies.

::

    import numpy as np
    from repro_torch.core import EngineOptions, SpinnerConfig
    from repro_torch.serve import PartitionScheduler

    opts = EngineOptions(score_backend="torch")   # on the card
    sched = PartitionScheduler(max_batch=8)
    sched.add_tenant("a", graph_a, SpinnerConfig(k=16), opts, partition=True)
    sched.add_tenant("b", graph_b, SpinnerConfig(k=16), opts, partition=True)
    sched.submit("a", "edge_updates", edge_updates=(src, dst))
    sched.submit("a", "edge_updates", edge_updates=(src2, dst2))  # coalesces
    tk = sched.submit("b", "adapt")
    sched.drain()                       # one round, one batched run
    labels = tk.result.labels
    print(sched.stats()["batch_occupancy"])

Synthetic open-loop traffic (Poisson bursts, power-law tenant sizes)
lives in :mod:`repro_torch.serve.traffic`.
"""
from . import traffic
from .requests import KINDS, Tenant, Ticket
from .scheduler import (KSweepPrecompile, PartitionScheduler, StagePrefetch,
                        default_batch_min, default_policies)

__all__ = [
    "PartitionScheduler", "Ticket", "Tenant", "KINDS",
    "StagePrefetch", "KSweepPrecompile", "default_policies",
    "default_batch_min", "traffic",
]
