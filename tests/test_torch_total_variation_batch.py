"""Batched solves of the sparse-gradient and total-variation trees,
tramp_tpu_torch against tramp_tpu, float64 on the CPU (the single-instance
parity is tests/test_torch_total_variation.py).

- ``EPSolver.solve_batch`` on 3 trees of tests/test_spectral_carry.py:50-58
  (``stack_models``: an operator each), the counterpart of
  tests/test_spectral_carry.py:130-145: each lane against the JAX solve of
  its tree (equal n_iter, r and v at rtol 1e-8);
- 3 TV regressions (2-D image) on one A with an observation each
  (``with_buffers``), whose lanes hold the L21 prior's group axis, shifted
  one along by the lane axis (priors/map_priors.py): each lane against the
  JAX package's solve.
"""
import jax.numpy as jnp
import numpy as np
import torch

from tramp_tpu import models as jmodels
from tramp_tpu.parallel import EPSolver as JEPSolver

from tramp_tpu_torch import models
from tramp_tpu_torch.lanes import stack_models, with_buffers
from tramp_tpu_torch.parallel import EPSolver

from test_torch_total_variation import CASES, CPU, _init, _instance
from torch_parity import assert_close


def _tree(seed, N=32, M=24):
    "tests/test_spectral_carry.py:50-58, both packages."
    rng = np.random.RandomState(seed)
    x0 = np.zeros(N)
    x0[: N // 2] = 1.0
    A = rng.randn(M, N) / np.sqrt(N)
    y = A @ x0 + 1e-3 * rng.randn(M)
    kw = dict(x_shape=(N,), grad_rho=0.1, noise_var=1e-3, prior_var=1.0)
    return (jmodels.sparse_gradient_regression(jnp.asarray(A),
                                               jnp.asarray(y), **kw),
            models.sparse_gradient_regression(A, y, **kw, **CPU))


def test_batched_solver_tree():
    "3 trees, an operator each, in one batched solve: lane i = its solve."
    pairs = [_tree(s) for s in (2, 3, 4)]
    stacked = stack_models([m for _, m in pairs])
    kw = dict(damping=0.1, tol=1e-8, max_iter=150)
    post, n_iter = EPSolver(pairs[0][1], **kw).solve_batch(stacked)
    for i, (j_model, _) in enumerate(pairs):
        j_post, j_n = JEPSolver(j_model, **kw).solve(j_model)
        assert int(n_iter[i]) == int(j_n)
        for key in ("r", "v"):
            assert_close(post["x"][key][i], j_post["x"][key], 1e-8,
                         what=f"lane {i} {key}")


def test_batched_tv_lanes():
    """3 TV regressions on one A, a y each (with_buffers): each lane
    against its single solve in the port and the JAX package's solve."""
    x_shape, kw = CASES["tv_regression_2d"]
    A, _, _ = _instance(x_shape, 0)
    rng = np.random.RandomState(9)
    ys = A @ np.cumsum(rng.randn(3, A.shape[1]) * (rng.rand(3, A.shape[1])
                                                   < 0.2), axis=1).T
    ys = ys.T + 1e-2 * rng.randn(3, A.shape[0])
    build = dict(x_shape=x_shape, noise_var=1e-2, prior_var=1.0, **kw)
    model = models.tv_regression(A, ys[0], **build, **CPU)
    index = next(i for i, f in enumerate(model.factors)
                 if type(f).__name__ == "GaussianLikelihood")
    batch = with_buffers(model, {(index, "y"): torch.as_tensor(ys)})
    solve = dict(damping=0.1, tol=1e-6, max_iter=80)
    post, n_iter = EPSolver(model, **solve).solve_batch(
        batch, initializer=_init("tv", jax=False))
    for i in range(3):
        j_model = jmodels.tv_regression(jnp.asarray(A), jnp.asarray(ys[i]),
                                        **build)
        j_post, j_n = JEPSolver(j_model, **solve).solve(
            j_model, initializer=_init("tv"))
        assert int(n_iter[i]) == int(j_n)
        for key in ("r", "v"):
            assert_close(post["x"][key][i], j_post["x"][key], 1e-8,
                         what=f"lane {i} {key}")
