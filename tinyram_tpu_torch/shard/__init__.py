"""Sharded execution over `torch.distributed`: the twin of `tinyram_tpu/shard/`."""

from .context import current_mesh, mesh_context
from .launch import RankError, run_on_mesh
from .mesh import Mesh, MeshRng, backend_for, make_mesh, rank_devices
from .msm import msm_many_sharded, msm_sharded
from .ntt import ntt_sharded

__all__ = [
    "Mesh", "MeshRng", "RankError", "backend_for", "current_mesh",
    "make_mesh", "mesh_context", "msm_many_sharded", "msm_sharded",
    "ntt_sharded", "rank_devices", "run_on_mesh",
]
