"""Phase-diagram grids: the reference's sequential experiment sweep
(tramp/experiments/multiple_experiments.py:30-49) as ONE batched SE solve.
Counterpart of tramp_tpu/parallel/grid.py on one card.

The grid points are the lanes of one stacked model
(``lanes.stack_models``): each grid axis must be a numeric hyperparameter
of its factor (``alpha``, ``prior_rho``, ...), so that the models stack.
"""
import itertools

import numpy as np

from ..lanes import stack_models
from .solver import SESolver


def grid_combos(grid_kwargs):
    "Cartesian product of the grid axes as a list of kwarg dicts."
    keys = list(grid_kwargs.keys())
    values = [np.atleast_1d(v) for v in grid_kwargs.values()]
    return [dict(zip(keys, combo))
            for combo in itertools.product(*values)]


def se_phase_grid_records(model_builder, grid_kwargs, ids=("x",), a0=None,
                          mesh=None, max_iter=200, tol=1e-6, damping=None,
                          solver_cls=SESolver, device=None, dtype=None,
                          **model_kwargs):
    """``run_se_phase_grid`` without pandas: the list of records, one dict
    per (grid point, variable id) with the grid kwargs, ``id``, ``v`` and
    ``n_iter``."""
    from ..algos import CustomInit

    if mesh is not None:
        raise NotImplementedError(
            "run_se_phase_grid runs on one card: the mesh path is not "
            "ported yet (ROADMAP Queue 1 item 5)")
    combos = grid_combos(grid_kwargs)
    models = [model_builder(**{k: v.item() for k, v in kw.items()},
                            **model_kwargs) for kw in combos]
    solver = solver_cls(models[0], damping=damping, tol=tol,
                        max_iter=max_iter, device=device, dtype=dtype)
    stacked = stack_models(models, device=solver.engine.device,
                           dtype=solver.engine.dtype)
    initializer = None
    if a0 is not None:
        initializer = CustomInit(a_init=[(ids[0], "bwd", a0)])
    post, n_iter = solver.solve_batch(stacked, initializer=initializer)

    records = []
    n_iter = n_iter.cpu().numpy()
    for id in ids:
        v = post[id]["v"].double().cpu().numpy().reshape(len(models), -1)
        v = v.mean(axis=-1)
        for i, kw in enumerate(combos):
            rec = {k: np.asarray(val).item() for k, val in kw.items()}
            rec.update(id=id, v=float(v[i]), n_iter=int(n_iter[i]))
            records.append(rec)
    return records


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
    mesh : must be None: the port runs on one card.
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
    "Write the grid DataFrame to CSV. Returns True (one process writes)."
    df.to_csv(csv_file, index=False)
    return True
