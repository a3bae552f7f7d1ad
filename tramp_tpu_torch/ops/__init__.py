"""Fused operations: hand-written CUDA kernels and their plain twins."""
from .pl_fused import (
    pl_posterior, pl_posterior_plain,
    pl_forward_message, pl_forward_message_plain,
    pl_backward_message, pl_backward_message_plain,
)

__all__ = ["pl_posterior", "pl_posterior_plain",
           "pl_forward_message", "pl_forward_message_plain",
           "pl_backward_message", "pl_backward_message_plain"]
