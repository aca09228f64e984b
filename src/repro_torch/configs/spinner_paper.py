"""The paper's own experiment configurations (Section 5).

Algorithm parameters follow Section 5.1: c = 1.05, eps = 0.001, w = 5.
Graph workloads are seeded synthetic stand-ins for the paper's proprietary
datasets; the generator names are ``repro_torch.core.generators``'.
"""
from ..core.spinner import SpinnerConfig


def paper_config(k: int, seed: int = 0, **kw) -> SpinnerConfig:
    return SpinnerConfig(k=k, c=1.05, eps=1e-3, halt_window=5, seed=seed, **kw)


# (name, generator kwargs) quality-benchmark workloads
QUALITY_GRAPHS = {
    "smallworld-100k": ("watts_strogatz",
                        dict(n=100_000, k_nbrs=20, beta=0.3, seed=11)),
    "powerlaw-50k": ("powerlaw_ba", dict(n=50_000, m=8, seed=12)),
    "clustered-64k": ("clustered_graph",
                      dict(num_clusters=64, cluster_size=1000, p_in=0.02,
                           p_out_edges_per_v=2.0, seed=13)),
}

K_SWEEP = (2, 4, 8, 16, 32, 64, 128, 256, 512)
