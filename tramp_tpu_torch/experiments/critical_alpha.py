"""Phase-boundary search. Counterpart of
tramp_tpu/experiments/critical_alpha.py. ``device`` and ``dtype`` are those
of the SE solves (None: the first card, float64)."""
import logging

import numpy as np
import torch

from ..algos import StateEvolution, CustomInit

logger = logging.getLogger(__name__)


def binary_search(f, xmin, xmax, xtol):
    "Binary search on boolean f, assuming f(xmin)=0 and f(xmax)=1. Ref l:7-28."
    ymin, ymax = f(xmin), f(xmax)
    if not (ymin == 0 and ymax == 1):
        raise ValueError(f"Bad bounds: ymin={ymin} and ymax={ymax}")
    max_iter = int(np.log2((xmax - xmin) / xtol)) + 2
    xmid = 0.5 * (xmin + xmax)
    for n_iter in range(1, max_iter + 1):
        xmid = 0.5 * (xmin + xmax)
        ymid = f(xmid)
        xerr = xmax - xmin
        logger.info(f"binary search {n_iter}/{max_iter} xerr={xerr}")
        if xerr < xtol:
            break
        if ymid == 0:
            xmin, ymin = xmid, ymid
        else:
            xmax, ymax = xmid, ymid
    if not (ymin == 0 and ymax == 1 and xerr < xtol):
        raise RuntimeError(f"binary search ended with xerr={xerr}")
    return dict(xmid=xmid, xmin=xmin, xmax=xmax, xerr=xerr, n_iter=n_iter)


def _tau(model, id):
    return float(torch.as_tensor(model.get_second_moments()[id]).mean())


def find_state_evolution_mse(id, a0, alpha, model_builder, device=None,
                             dtype=None, **model_kwargs):
    "SE mse of variable `id` with informed init a0. Reference l:31-57."
    model = model_builder(alpha=alpha, **model_kwargs)
    initializer = CustomInit(a_init=[(id, "bwd", a0)])
    se = StateEvolution(model, device=device, dtype=dtype)
    se.iterate(max_iter=200, initializer=initializer)
    return float(se.get_variable_data(id=id)["v"].mean())


def find_critical_alpha(id, a0, mse_criterion, alpha_min, alpha_max,
                        model_builder, alpha_tol=1e-6, vtol=1e-3,
                        device=None, dtype=None, **model_kwargs):
    "Binary search for the critical measurement density. Reference l:60-109."
    if mse_criterion == "perfect":
        def mse_criterion(v):
            return abs(v) < vtol
    elif mse_criterion == "random":
        tau_x = _tau(model_builder(alpha=0.5, **model_kwargs), id)

        def mse_criterion(v):
            return abs(v - tau_x) > vtol

    def f(alpha):
        v = find_state_evolution_mse(
            id, a0, alpha, model_builder, device=device, dtype=dtype,
            **model_kwargs)
        return mse_criterion(v)

    search = binary_search(f, alpha_min, alpha_max, alpha_tol)
    return search["xmid"]


def find_critical_alpha_batched(id, a0, mse_criterion, alpha_min, alpha_max,
                                model_builder, alpha_tol=1e-6, vtol=1e-3,
                                grid_kwargs=None, max_iter=200, device=None,
                                dtype=None, **model_kwargs):
    """Vectorized phase-boundary search: a whole family of critical lines
    in one batched bisection.

    The reference computes each grid line with an independent sequential
    binary search (tramp/experiments/critical_alpha.py:60-109); here every
    bisection *level* is ONE batched SE solve over all lines: alpha is a
    numeric hyperparameter of MarchenkoPasturChannel, so the L models stack
    into one model with L lanes.

    Parameters
    ----------
    grid_kwargs : dict of per-line lists (all the same length L), e.g.
        ``{"prior_rho": np.linspace(0.05, 0.95, 19)}``. Each kwarg must be
        a numeric hyperparameter of its factor, so the L models stack.
        Structural kwargs (e.g. ``output_width``) go in ``model_kwargs`` and
        are shared by all lines.
    mse_criterion : "perfect" | "random" | a sequence of L of these names,
        one per line | callable v -> bool array.

    Returns an np.ndarray of L critical alphas, identical to running the
    sequential ``find_critical_alpha`` per line (same bisection schedule:
    the midpoint of the first bracket narrower than ``alpha_tol``).
    """
    from ..parallel.solver import SESolver
    from ..lanes import model_lanes, stack_models

    grid_kwargs = dict(grid_kwargs or {})
    L = len(next(iter(grid_kwargs.values()))) if grid_kwargs else 1

    def kwargs_for(line):
        kw = dict(model_kwargs)
        kw.update({k: float(v[line]) for k, v in grid_kwargs.items()})
        return kw

    rep = model_builder(alpha=0.5 * (alpha_min + alpha_max), **kwargs_for(0))
    solver = SESolver(rep, max_iter=max_iter, tol=1e-6, device=device,
                      dtype=dtype)
    initializer = CustomInit(a_init=[(id, "bwd", a0)])

    def build(alphas):
        models = [model_builder(alpha=float(alphas[line]),
                                **kwargs_for(line)) for line in range(L)]
        return stack_models(models, device=solver.engine.device,
                            dtype=solver.engine.dtype)

    if not callable(mse_criterion):
        names = ([mse_criterion] * L if isinstance(mse_criterion, str)
                 else list(mse_criterion))
        if len(names) != L or not set(names) <= {"perfect", "random"}:
            raise ValueError(f"mse_criterion {mse_criterion!r} for {L} lines")
        random = np.array([name == "random" for name in names])
        tau_x = np.array([
            _tau(model_builder(alpha=0.5, **kwargs_for(line)), id)
            if random[line] else 0.0 for line in range(L)])

        def mse_criterion(v):
            return np.where(random, np.abs(v - tau_x) > vtol, np.abs(v) < vtol)

    def f(alphas):
        "One batched SE solve over all L lines; returns bool array (L,)."
        stacked = build(alphas)
        if model_lanes(stacked, rep) is None:
            # all lines are the same model: one solve stands for them all
            post, _ = solver.solve(stacked, initializer=initializer)
        else:
            post, _ = solver.solve_batch(stacked, initializer=initializer)
        v = np.broadcast_to(
            post[id]["v"].double().cpu().numpy().reshape(-1), (L,))
        return np.asarray(mse_criterion(v), dtype=bool)

    lo = np.full(L, float(alpha_min))
    hi = np.full(L, float(alpha_max))
    y_lo, y_hi = f(lo), f(hi)
    if y_lo.any() or not y_hi.all():
        bad = np.nonzero(y_lo | ~y_hi)[0]
        raise ValueError(
            f"Bad bounds on lines {bad.tolist()}: ymin={y_lo[bad].tolist()} "
            f"ymax={y_hi[bad].tolist()}")
    max_levels = int(np.log2((alpha_max - alpha_min) / alpha_tol)) + 2
    for level in range(1, max_levels + 1):
        if (hi - lo).max() < alpha_tol:
            break
        mid = 0.5 * (lo + hi)
        y = f(mid)
        logger.info(f"batched bisection {level}/{max_levels} "
                    f"xerr={(hi - lo).max()}")
        lo = np.where(y, lo, mid)
        hi = np.where(y, mid, hi)
    if not (hi - lo).max() < alpha_tol:
        raise RuntimeError("the batched bisection did not reach alpha_tol")
    return 0.5 * (lo + hi)
