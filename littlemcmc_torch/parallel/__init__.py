"""Cross-chain pooled adaptation (:mod:`.cross_chain`)."""

from .cross_chain import cross_chain_potential_pool

__all__ = ["cross_chain_potential_pool"]
