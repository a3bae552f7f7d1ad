"""Belief log-partitions and moments."""
from . import normal, sparse

__all__ = ["normal", "sparse"]
