"""Mesh, halo exchange and the sharded Monte-Carlo sweep (torch.distributed)."""

from ofdm_tpu_torch.parallel import halo
from ofdm_tpu_torch.parallel.mesh import Mesh, distributed_init, make_mesh
from ofdm_tpu_torch.parallel.sweep import ShardedLinkRunner, run_sweep

__all__ = ["Mesh", "ShardedLinkRunner", "distributed_init", "halo", "make_mesh", "run_sweep"]
