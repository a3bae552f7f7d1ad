"""Phase-diagram grids: the reference's sequential experiment sweep
(tramp/experiments/multiple_experiments.py:30-49) as ONE batched SE solve,
on one card or sharded over a device mesh. Counterpart of
tramp_tpu/parallel/grid.py.

The grid points are the lanes of one stacked model
(``lanes.stack_models``): each grid axis must be a numeric hyperparameter
of its factor (``alpha``, ``prior_rho``, ...), so that the models stack.
On a mesh the points are split over its ``data`` axis, and every process
receives the whole grid; one process (rank 0) writes the CSV.

A grid is solved in three steps, which ``se_phase_grid_records`` runs in
turn: ``build_se_grid`` (span ``grid.build``), ``solve_se_grid`` (the
solver's ``solve``) and ``se_grid_records`` (span ``grid.records``).
"""
import collections
import itertools

import numpy as np
import torch.distributed as dist

from .. import trace
from ..lanes import stack_models
from .mesh import axis_size, shard_batched_model
from .solver import SESolver


def grid_combos(grid_kwargs):
    "Cartesian product of the grid axes as a list of kwarg dicts."
    keys = list(grid_kwargs.keys())
    values = [np.atleast_1d(v) for v in grid_kwargs.values()]
    return [dict(zip(keys, combo))
            for combo in itertools.product(*values)]


#: a grid built for its solve (``build_se_grid``): the grid kwargs of each
#: point, the ids reported, the solver, the points' models stacked into
#: lanes (sharded on a mesh) and the initializer
SEGrid = collections.namedtuple("SEGrid",
                                "combos ids solver stacked initializer")


def build_se_grid(model_builder, grid_kwargs, ids=("x",), a0=None,
                  mesh=None, max_iter=200, tol=1e-6, damping=None,
                  solver_cls=SESolver, device=None, dtype=None,
                  **model_kwargs):
    """The first step of ``se_phase_grid_records``: the points' models built
    and stacked, the solver made, in the span ``grid.build``. Returns an
    ``SEGrid`` for ``solve_se_grid``."""
    from ..algos import CustomInit

    with trace.span("grid.build"):
        combos = grid_combos(grid_kwargs)
        n = len(combos)
        models = [model_builder(**{k: v.item() for k, v in kw.items()},
                                **model_kwargs) for kw in combos]
        if mesh is not None:
            # the last point repeated up to a multiple of the data axis, so
            # that every rank holds as many points
            models += [models[-1]] * ((-n) % axis_size(mesh, "data"))
        solver = solver_cls(models[0], damping=damping, tol=tol,
                            max_iter=max_iter, device=device, dtype=dtype)
        stacked = stack_models(models, device=solver.engine.device,
                               dtype=solver.engine.dtype)
        if mesh is not None:
            stacked = shard_batched_model(stacked, mesh)
        initializer = None
        if a0 is not None:
            initializer = CustomInit(a_init=[(ids[0], "bwd", a0)])
        return SEGrid(combos, tuple(ids), solver, stacked, initializer)


def solve_se_grid(grid):
    """The second step: the grid's one batched solve, ``(post, n_iter)``
    over its stacked lanes (``SESolver.solve_batch``)."""
    return grid.solver.solve_batch(grid.stacked,
                                   initializer=grid.initializer)


def se_grid_records(grid, post, n_iter):
    """The last step: the solve's answers read back to the host as records,
    one dict per (grid point, variable id) with the grid kwargs, ``id``,
    ``v`` and ``n_iter``, in the span ``grid.records``. The solve's lanes
    past the grid's points (a mesh's padding) are left out."""
    with trace.span("grid.records"):
        n = len(grid.combos)
        lanes = n_iter.shape[0]
        records = []
        n_iter = n_iter.cpu().numpy()[:n]
        for id in grid.ids:
            v = post[id]["v"].double().cpu().numpy().reshape(lanes, -1)
            v = v.mean(axis=-1)[:n]
            for i, kw in enumerate(grid.combos):
                rec = {k: np.asarray(val).item() for k, val in kw.items()}
                rec.update(id=id, v=float(v[i]), n_iter=int(n_iter[i]))
                records.append(rec)
        return records


def se_phase_grid_records(model_builder, grid_kwargs, ids=("x",), a0=None,
                          mesh=None, max_iter=200, tol=1e-6, damping=None,
                          solver_cls=SESolver, device=None, dtype=None,
                          **model_kwargs):
    """``run_se_phase_grid`` without pandas: the list of records, one dict
    per (grid point, variable id) with the grid kwargs, ``id``, ``v`` and
    ``n_iter``. Its three steps are ``build_se_grid``, ``solve_se_grid``
    and ``se_grid_records``."""
    grid = build_se_grid(model_builder, grid_kwargs, ids=ids, a0=a0,
                         mesh=mesh, max_iter=max_iter, tol=tol,
                         damping=damping, solver_cls=solver_cls,
                         device=device, dtype=dtype, **model_kwargs)
    return se_grid_records(grid, *solve_se_grid(grid))


def run_se_phase_grid(model_builder, grid_kwargs, **kwargs):
    """Solve an SE phase grid as one batched solve.

    Parameters
    ----------
    model_builder : callable(**kwargs) -> Model. Grid axes must map to
        numeric hyperparameters of the factors so the models stack.
    grid_kwargs : dict name -> list of values; the grid is their cartesian
        product (reference get_experiments_from_kwargs semantics).
    ids : variables to report, ``("x",)`` by default.
    a0 : optional informed-init precision for ``ids[0]`` (CustomInit).
    mesh : optional ``DeviceMesh`` (``make_mesh``); the grid points are
        split over its "data" axis (padded to a multiple of its size with
        the last point repeated), and every process gets the whole grid.
    max_iter, tol, damping, solver_cls : of the solve.
    device, dtype : of the solve (None: the first card, float64).
    Other keywords go to ``model_builder`` for every grid point.

    Returns a pandas DataFrame with one row per (grid point, variable id):
    grid kwargs + v + n_iter.
    """
    import pandas as pd
    return pd.DataFrame(
        se_phase_grid_records(model_builder, grid_kwargs, **kwargs))


def save_grid_csv(df, csv_file):
    """Write the grid DataFrame to CSV on rank 0 only (every process holds
    the whole grid; one writes). Returns True on the writing process."""
    if dist.is_initialized() and dist.get_rank() != 0:
        return False
    df.to_csv(csv_file, index=False)
    return True
