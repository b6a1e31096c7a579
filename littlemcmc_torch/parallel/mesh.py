"""Device meshes for chain-parallel sampling: one rank per device.

Counterpart of ``littlemcmc_tpu/parallel/mesh.py`` (``chain_mesh`` ``:14``,
``shard_chains`` ``:27``). A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with a ``chains`` dimension;
``sample(..., mesh=mesh)`` splits the chain batch over that dimension's
ranks, rank ``r`` of ``D`` sampling global chains ``[r C/D, (r+1) C/D)``.

Departure from JAX: a JAX process can drive several devices, so
``chain_mesh(n)`` there spans ``n`` of the process's devices. PyTorch puts
one device in each process, so a mesh of more than one device needs one
process per device, joined by
:func:`~littlemcmc_torch.parallel.distributed.initialize_distributed`
(or ``torchrun``): ``chain_mesh(n)`` with ``n > 1`` and no process group
raises. Without a process group, ``chain_mesh()`` is a mesh of one rank
over an in-process group of world size one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["chain_mesh", "shard_chains", "ChainShard", "chain_shard"]


def chain_mesh(n_devices: Optional[int] = None, axis: str = "chains"):
    """A 1-D ``DeviceMesh`` named ``axis`` over every rank of the process
    group (one device each); ``n_devices``, where given, must be that rank
    count. Without a process group: a mesh of one rank, for which this
    call starts a Gloo group of world size one on an in-process store.

    The mesh's device type is ``"cuda"`` under NCCL and ``"cpu"`` under
    Gloo, whose collectives go through host memory; the chains sample on
    ``sample()``'s ``device`` either way.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"chain_mesh({n_devices}): PyTorch runs one device per process, so a mesh "
                f"of {n_devices} devices needs {n_devices} processes; launch one process per "
                "device (torchrun, or initialize_distributed in each) and call chain_mesh() "
                "in every one.")
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"chain_mesh({n_devices}): the process group has {world} rank(s); "
                         "a chain mesh spans all of them, one device each.")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


@dataclasses.dataclass(frozen=True)
class ChainShard:
    """This rank's part of a chain batch split over a mesh dimension:
    ``chains`` in all, ``size`` ranks in ``group``, this one ``rank``."""

    group: object
    rank: int
    size: int
    chains: int

    @property
    def local(self) -> int:
        """The chains of one rank."""
        return self.chains // self.size

    @property
    def lo(self) -> int:
        """This rank's first global chain."""
        return self.rank * self.local

    def rows(self, x):
        """This rank's rows of a global chain batch (a view)."""
        return x[self.lo:self.lo + self.local]


def chain_shard(mesh, axis: str, chains: int) -> ChainShard:
    """The :class:`ChainShard` of ``chains`` over ``mesh``'s dimension
    ``axis``; raises where the mesh has no such dimension or the chains do
    not split evenly (``littlemcmc_tpu/sampling.py:1165-1171``)."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no dimension named {axis!r}: {names}")
    size = mesh.size(names.index(axis))
    if chains % size != 0:
        raise ValueError(f"chains ({chains}) must be divisible by the {axis!r} "
                         f"mesh axis size ({size})")
    return ChainShard(group=mesh.get_group(axis), rank=mesh.get_local_rank(axis),
                      size=size, chains=chains)


def shard_chains(tree, mesh, axis: str = "chains"):
    """This rank's rows of every leading chain axis of a chain-batched
    tensor, dataclass, tuple, list or dict."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no dimension named {axis!r}: {names}")
    size, rank = mesh.size(names.index(axis)), mesh.get_local_rank(axis)

    def take(x):
        if isinstance(x, torch.Tensor):
            if x.shape[0] % size:
                raise ValueError(f"{x.shape[0]} chains do not split over {size} ranks")
            local = x.shape[0] // size
            return x[rank * local:(rank + 1) * local]
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: take(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(take(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        return x

    return take(tree)
