"""tramp_tpu_torch: the PyTorch and CUDA port of tramp_tpu.

Models are DAGs of priors, channels and likelihoods composed with ``@``;
``ExpectationPropagation(model).iterate(...)`` runs EP message passing over
the statically lowered schedule; ``parallel.dispatch_solver(model)`` picks
the fastest solver for a model, with single and batched solves. The
piecewise-linear posterior runs as a
hand-written CUDA kernel on NVIDIA Hopper GPUs and as plain PyTorch on the
CPU. The JAX package tramp_tpu is the reference this port is held against.
"""
from . import beliefs, utils, ops, priors, channels, likelihoods, parallel
from .variables import V, O
from .models import Model
from .algos import (
    ExpectationPropagation, ConstantInit, EarlyStopping, EarlyStoppingEP,
)

__all__ = [
    "beliefs", "utils", "ops", "priors", "channels", "likelihoods",
    "parallel", "V", "O",
    "Model", "ExpectationPropagation", "ConstantInit", "EarlyStopping",
    "EarlyStoppingEP",
]
