"""Fused operations: hand-written CUDA kernels and their plain twins."""
from .pl_fused import pl_posterior, pl_posterior_plain

__all__ = ["pl_posterior", "pl_posterior_plain"]
