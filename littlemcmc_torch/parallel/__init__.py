"""Parallel runtime: chains split over ranks, and pooled adaptation.

Counterpart of ``littlemcmc_tpu/parallel``: :mod:`.mesh` (a ``chains``
mesh of one rank per device), :mod:`.distributed` (the process group and
the collectives) and :mod:`.cross_chain` (pooled adaptation, over every
rank's chains under a mesh).
"""

from .cross_chain import cross_chain_potential_pool, lowrank_boundary_refresh
from .distributed import global_chain_mesh, initialize_distributed, process_local_chains
from .mesh import chain_mesh, shard_chains

__all__ = [
    "chain_mesh",
    "shard_chains",
    "cross_chain_potential_pool",
    "lowrank_boundary_refresh",
    "initialize_distributed",
    "global_chain_mesh",
    "process_local_chains",
]
