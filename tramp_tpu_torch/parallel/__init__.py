"""The dispatched fast solvers and their batched solves. Counterpart of
tramp_tpu/parallel (``EPSolver``, ``SpectralVAMPSolver``, ``MLVAMPSolver``,
``dispatch_solver``); ``stack_models`` and ``with_buffers`` take the place
of ``stack_pytrees``."""
from ..lanes import stack_models, with_buffers
from .ml_vamp import MLVAMPSolver, dispatch_solver
from .solver import EPSolver
from .vamp_glm import SpectralVAMPSolver

__all__ = ["EPSolver", "SpectralVAMPSolver", "MLVAMPSolver",
           "dispatch_solver", "stack_models", "with_buffers"]
