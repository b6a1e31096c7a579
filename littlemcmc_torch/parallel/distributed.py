"""Several processes, one device each: the process group and the collectives.

Counterpart of ``littlemcmc_tpu/parallel/distributed.py``
(``initialize_distributed`` ``:27``, ``global_chain_mesh`` ``:47``,
``process_local_chains`` ``:52``), in PyTorch's idiom: one process per
device, joined by ``torch.distributed``. Every process runs the same
``sample()`` call with ``mesh=global_chain_mesh()``; each samples its own
rows of the chain batch and the collectives below carry what crosses the
ranks: the pooled adaptation's Welford states, the tree's stop votes, the
divergence counts the host reads, and the trace gathered at the end.

Backends: ``"nccl"`` where every rank of a host has a CUDA device of its
own, else ``"gloo"``. NCCL refuses two ranks on one device, so several
ranks sharing one card run Gloo: they still sample on the card, and only
the collectives go through host memory (a CUDA tensor is copied to the
host, gathered and copied back). ``sample()`` reports the backend and the
seconds spent in collectives (``perf_report["backend"]``,
``["collective_seconds"]``).

The chain order across ranks is the rank order: rank ``r`` of ``D`` holds
global chains ``[r C/D, (r + 1) C/D)``. :func:`gather_chains` and
:func:`gather_tree` rebuild the global batch in that order, so a pooled
statistic computed on the gathered batch has the bits of the unsharded
run's.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "global_chain_mesh", "process_local_chains",
           "default_backend", "group_rank_size", "collective_seconds", "gather_chains",
           "gather_to_host", "gather_tree", "local_rows", "all_any", "all_sum", "broadcast_int", "barrier"]

# seconds spent in this module's collectives, host copies included
_SECONDS = [0.0]


def default_backend(num_processes: Optional[int] = None) -> str:
    """``"nccl"`` where every rank on this host can have a CUDA device of
    its own (``LOCAL_WORLD_SIZE``, else ``num_processes``, at most the
    device count), else ``"gloo"``."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes or 1))
    if (torch.cuda.is_available() and dist.is_nccl_available()
            and torch.cuda.device_count() >= local):
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout: Optional[float] = None) -> str:
    """Join the process group (a no-op where one is up, as JAX's ``:36-44``);
    returns its backend.

    ``coordinator_address``: ``host:port`` of rank 0 (or a ``tcp://`` or
    ``file://`` URL); None reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as do ``num_processes`` and
    ``process_id`` when None. ``backend`` defaults to
    :func:`default_backend`; under NCCL each rank takes the device
    ``LOCAL_RANK`` (else its rank modulo the device count). ``timeout``:
    seconds a collective waits before it fails.
    """
    if dist.is_initialized():
        return dist.get_backend()
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = backend or default_backend(world)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 rank % torch.cuda.device_count())))
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=float(timeout))}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kw)
    return backend


def global_chain_mesh(axis: str = "chains"):
    """One mesh axis over every rank of the process group."""
    from .mesh import chain_mesh

    return chain_mesh(None, axis)


def process_local_chains(total_chains: int) -> int:
    """How many of ``total_chains`` this process hosts (the chains split
    evenly over the ranks)."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if total_chains % n_proc != 0:
        raise ValueError(
            f"total_chains ({total_chains}) must be divisible by process count ({n_proc})")
    return total_chains // n_proc


def group_rank_size(group) -> tuple:
    """``(rank, size)`` of this process in ``group`` (``(0, 1)`` for None)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def collective_seconds() -> float:
    """Seconds this process has spent in the collectives of this module."""
    return _SECONDS[0]


class _Timed:
    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        _SECONDS[0] += time.perf_counter() - self.t0


def _on_host(group) -> bool:
    return dist.get_backend(group) != "nccl"


def _int_tensor(value: int, group) -> torch.Tensor:
    """A one-element int64 tensor where ``group``'s backend takes it."""
    dev = "cpu" if _on_host(group) else torch.device("cuda", torch.cuda.current_device())
    return torch.tensor([int(value)], dtype=torch.int64, device=dev)


def _all_gather(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` (the same shape on each), in rank order, on
    ``x``'s device."""
    _, size = group_rank_size(group)
    with _Timed():
        if _on_host(group):
            xh = x.detach().to("cpu").contiguous()
            out = [torch.empty_like(xh) for _ in range(size)]
            dist.all_gather(out, xh, group=group)
            return [o.to(x.device) for o in out]
        out = [torch.empty_like(x.contiguous()) for _ in range(size)]
        dist.all_gather(out, x.contiguous(), group=group)
        return out


def gather_chains(x: torch.Tensor, group) -> torch.Tensor:
    """The global chain batch from every rank's rows of ``x`` (chains
    first), in rank order. A batch that is one row ``expand``-ed over the
    chains (a pooled metric's replicated form) crosses as that row and,
    where every rank holds the same row, comes back as that row expanded
    over all the chains: the layout of the unsharded run's tensor."""
    rank, size = group_rank_size(group)
    if size == 1:
        return x
    if x.ndim >= 1 and x.shape[0] > 0 and x.stride(0) == 0:
        rows = _all_gather(x[:1], group)
        if all(torch.equal(rows[0], r) for r in rows[1:]):
            return rows[0].expand(x.shape[0] * size, *x.shape[1:])
        return torch.cat([r.expand(x.shape[0], *x.shape[1:]) for r in rows])
    return torch.cat(_all_gather(x, group))


def gather_to_host(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`gather_chains` of ``x`` as a host tensor: under Gloo the rows
    cross from the host, under NCCL from the device."""
    if group_rank_size(group)[1] == 1:
        return x.cpu()
    if _on_host(group):
        return gather_chains(x.cpu().contiguous(), group)
    return gather_chains(x.contiguous(), group).cpu()


def _map_tree(tree, fn):
    """``fn`` on every tensor of a dataclass tree (a metric, a state)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _map_tree(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree)})
    return tree


def gather_tree(tree, group):
    """:func:`gather_chains` on every tensor of a chain-batched dataclass
    (a metric, a ``ChainState``)."""
    if group_rank_size(group)[1] == 1:
        return tree
    return _map_tree(tree, lambda x: gather_chains(x, group))


def local_rows(tree, group, local: int):
    """This rank's ``local`` rows of every tensor of a global chain-batched
    dataclass (views)."""
    rank, size = group_rank_size(group)
    if size == 1:
        return tree
    return _map_tree(tree, lambda x: x[rank * local:(rank + 1) * local])


def all_any(flag, group) -> bool:
    """Whether ``flag`` (a bool or a bool tensor's ``any``) holds on any rank."""
    local = bool(flag.any()) if isinstance(flag, torch.Tensor) else bool(flag)
    if group_rank_size(group)[1] == 1:
        return local
    with _Timed():
        t = _int_tensor(local, group)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def all_sum(value: int, group) -> int:
    """The sum of an integer over the ranks."""
    if group_rank_size(group)[1] == 1:
        return int(value)
    with _Timed():
        t = _int_tensor(value, group)
        dist.all_reduce(t, group=group)
    return int(t.item())


def broadcast_int(value: int, group, src: int = 0) -> int:
    """Rank ``src``'s integer on every rank."""
    if group_rank_size(group)[1] == 1:
        return int(value)
    with _Timed():
        t = _int_tensor(value, group)
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return int(t.item())


def barrier(group) -> None:
    """Wait for every rank of ``group``."""
    if group_rank_size(group)[1] > 1:
        with _Timed():
            dist.barrier(group=group)
