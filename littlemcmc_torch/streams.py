"""Per-chain counter streams: the random source of a run seeded with one
seed per chain.

Counterpart of the JAX package's per-chain keys for a seed list
(``_resolve_chain_keys``, ``littlemcmc_tpu/sampling.py:414-440``). Every
number a chain draws is a hash (``_fmix32``, the finalizer the kernels'
counter stream uses) of its own seed, the global iteration and a counter
within the draw, so a chain's draws depend on its seed alone, whatever its
slot or its neighbours, and do not depend on how the run is chunked.

:class:`ChainStreams` holds the chains' keys; ``streams.draw(i)`` is the
:class:`DrawStream` of global iteration ``i``, which the per-draw kernels
take where they otherwise take a ``torch.Generator``: its momenta
(:func:`randn`), uniforms (:func:`rand`) and the NUTS tree's keyed random
source (:func:`tree_random`). A run with one master seed keeps its
``torch.Generator`` and draws nothing from here.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["ChainStreams", "DrawStream", "KeyedTreeRandom", "randn", "rand", "tree_random",
           "torch_generator"]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 tensors holding uint32 words
    (the kernels' ``_fmix32``)."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def _mix(key: torch.Tensor, salt) -> torch.Tensor:
    """A new word from ``key`` and ``salt`` (an int or a tensor that
    broadcasts against ``key``)."""
    return _fmix32(_fmix32(key) ^ ((salt * _GOLDEN + 0x7F4A7C15) & _M32))


def _unit(bits: torch.Tensor, dtype) -> torch.Tensor:
    """Uniforms in (0, 1) from 32-bit words (their top 24 bits)."""
    return ((bits >> 8).to(dtype) + 0.5) * (1.0 / (1 << 24))


class ChainStreams:
    """The keys of ``seeds`` (one per chain) on ``device``."""

    def __init__(self, seeds: Sequence[int], device, generator: torch.Generator):
        words = torch.tensor([int(s) & _M32 for s in seeds], dtype=torch.int64, device=device)
        self.keys = _mix(words, 0x5EED)
        self.generator = generator

    def draw(self, iteration: int) -> "DrawStream":
        """The stream of global iteration ``iteration`` (-1: the start)."""
        return DrawStream(_mix(self.keys, iteration + 1), self.generator)


class DrawStream:
    """One iteration's numbers for every chain: each call takes the next
    counter. ``generator`` is the run's device ``torch.Generator`` (seeded
    from chain 0's seed), which a ``step_rand`` hook receives."""

    def __init__(self, keys: torch.Tensor, generator: torch.Generator):
        self.keys, self.generator, self.counter = keys, generator, 0

    def next_keys(self) -> torch.Tensor:
        self.counter += 1
        return _mix(self.keys, self.counter)

    def uniform(self, tail=(), dtype=torch.float32) -> torch.Tensor:
        """``(C, *tail)`` uniforms in (0, 1)."""
        k = self.next_keys()
        idx = torch.arange(math.prod(tail), dtype=torch.int64, device=k.device)
        bits = _mix(k[:, None], idx[None, :])
        return _unit(bits, dtype).reshape((k.shape[0],) + tuple(tail))

    def normal(self, tail=(), dtype=torch.float32) -> torch.Tensor:
        """``(C, *tail)`` standard normals (Box-Muller)."""
        u = self.uniform((2,) + tuple(tail), torch.float64)
        z = torch.sqrt(-2.0 * torch.log(u[:, 0])) * torch.cos((2.0 * math.pi) * u[:, 1])
        return z.to(dtype)


class KeyedTreeRandom:
    """The NUTS tree's random source on per-chain keys (the contract of
    :class:`~littlemcmc_torch.nuts.GeneratorTreeRandom`): keys are ``(C,)``
    words, a split hashes them, a masked select is per chain."""

    def split(self, keys: torch.Tensor, num: int):
        return tuple(_mix(keys, 0x7000 + j) for j in range(num))

    def where(self, mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(mask, a, b)

    def bernoulli(self, keys: torch.Tensor) -> torch.Tensor:
        return self.uniform(keys) < 0.5

    def uniform(self, keys: torch.Tensor) -> torch.Tensor:
        return _unit(_mix(keys, 0x6000), torch.float32)


def randn(shape, generator, dtype, device) -> torch.Tensor:
    """Standard normals of ``shape`` (chains first) from a
    ``torch.Generator`` or a :class:`DrawStream`."""
    if isinstance(generator, DrawStream):
        return generator.normal(tuple(shape[1:]), dtype)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def rand(chains: int, generator, dtype, device) -> torch.Tensor:
    """``(chains,)`` uniforms from a ``torch.Generator`` or a :class:`DrawStream`."""
    if isinstance(generator, DrawStream):
        return generator.uniform((), dtype)
    return torch.rand(chains, generator=generator, dtype=dtype, device=device)


def tree_random(generator, chains: int, device):
    """``(random source, keys)`` of the NUTS tree for one draw."""
    if isinstance(generator, DrawStream):
        return KeyedTreeRandom(), generator.next_keys()
    from .nuts import GeneratorTreeRandom

    return GeneratorTreeRandom(generator, chains, device), None


def torch_generator(generator) -> torch.Generator:
    """The ``torch.Generator`` behind ``generator`` (a ``step_rand`` hook's)."""
    return generator.generator if isinstance(generator, DrawStream) else generator
