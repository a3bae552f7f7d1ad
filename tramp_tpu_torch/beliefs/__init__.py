"""Belief log-partitions and moments."""
from . import normal, sparse, binary, positive, truncated, exponential, mixture

__all__ = ["normal", "sparse", "binary", "positive", "truncated",
           "exponential", "mixture"]
