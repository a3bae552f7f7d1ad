"""The dispatched fast solvers, their batched solves and the SE phase grids.
Counterpart of tramp_tpu/parallel (``EPSolver``, ``SESolver``,
``SpectralVAMPSolver``, ``MLVAMPSolver``, ``dispatch_solver``,
``run_se_phase_grid``, ``save_checkpoint`` / ``restore_checkpoint``);
``stack_models`` and ``with_buffers`` take the place of
``stack_pytrees``."""
from ..lanes import stack_models, with_buffers
from .checkpoint import save_checkpoint, restore_checkpoint
from .ml_vamp import MLVAMPSolver, dispatch_solver
from .solver import EPSolver, SESolver
from .vamp_glm import SpectralVAMPSolver
from .grid import (
    grid_combos, run_se_phase_grid, save_grid_csv, se_phase_grid_records,
)

__all__ = ["EPSolver", "SESolver", "SpectralVAMPSolver", "MLVAMPSolver",
           "dispatch_solver", "stack_models", "with_buffers", "grid_combos",
           "run_se_phase_grid", "se_phase_grid_records", "save_grid_csv",
           "save_checkpoint", "restore_checkpoint"]
