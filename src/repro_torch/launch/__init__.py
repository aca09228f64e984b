"""Process-group and mesh construction for the sharded engine."""
from .mesh import make_partition_mesh

__all__ = ["make_partition_mesh"]
