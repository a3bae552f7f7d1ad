"""The dispatched fast solvers, their batched solves, the SE phase grids and
the device mesh. Counterpart of tramp_tpu/parallel (``EPSolver``,
``SESolver``, ``SpectralVAMPSolver``, ``MLVAMPSolver``, ``dispatch_solver``,
``run_se_phase_grid``, ``save_checkpoint`` / ``restore_checkpoint``,
``make_mesh``, ``shard_batched_model``, ``shard_batched_state``,
``solve_batch_shard_map``); ``stack_models`` and ``with_buffers`` build the
batches, and ``stack_pytrees`` is the JAX package's name for
``stack_models``."""
from ..lanes import stack_models, with_buffers
from .checkpoint import save_checkpoint, restore_checkpoint
from .mesh import make_mesh, shard_batched_model, shard_batched_state
from .ml_vamp import MLVAMPSolver, dispatch_solver
from .solver import (
    EPSolver, SESolver, solve_batch_shard_map, stack_pytrees,
)
from .vamp_glm import SpectralVAMPSolver
from .grid import (
    SEGrid, build_se_grid, grid_combos, run_se_phase_grid, save_grid_csv,
    se_grid_records, se_phase_grid_records, solve_se_grid,
)

__all__ = ["EPSolver", "SESolver", "SpectralVAMPSolver", "MLVAMPSolver",
           "dispatch_solver", "stack_models", "stack_pytrees",
           "with_buffers", "grid_combos", "run_se_phase_grid",
           "se_phase_grid_records", "build_se_grid", "solve_se_grid",
           "se_grid_records", "SEGrid", "save_grid_csv", "save_checkpoint",
           "restore_checkpoint", "make_mesh", "shard_batched_model",
           "shard_batched_state", "solve_batch_shard_map"]
