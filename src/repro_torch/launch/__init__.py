"""Process-group and mesh construction: the sharded engine's 1-D mesh and
the LLM side's 2-D meshes."""
from .mesh import make_host_mesh, make_partition_mesh, make_production_mesh

__all__ = ["make_host_mesh", "make_partition_mesh", "make_production_mesh"]
