"""Full solves of the sparse-gradient trees, tramp_tpu_torch against
tramp_tpu, float64 on the CPU (one sweep of every builder is in
tests/test_torch_total_variation.py):

- the sparse-gradient regression of tests/test_structured_channels.py:
  146-172 through the engine, the port's builder against the JAX
  package's: equal n_iter, r and v at rtol 1e-8, and better than ridge;
- BASELINE config 3's student (bench.py:536-570, at N = 64, rho 0.1)
  through ``EPSolver``: equal n_iter, r and v at rtol 1e-8.
"""
import jax.numpy as jnp
import numpy as np
import torch

import tramp_tpu as jt
from tramp_tpu import models as jmodels
from tramp_tpu.parallel import EPSolver as JEPSolver

import tramp_tpu_torch as tt
from tramp_tpu_torch import models
from tramp_tpu_torch.parallel import EPSolver

from test_torch_total_variation import CPU, F64
from torch_parity import assert_close


def _solve_both(j_student, student, kw, j_init=None, init=None):
    post, n_iter = EPSolver(student, **kw).solve(student, initializer=init)
    j_post, j_n = JEPSolver(j_student, **kw).solve(j_student,
                                                   initializer=j_init)
    return post, int(n_iter), j_post, int(j_n)


def test_sparse_gradient_regression_solve():
    """tests/test_structured_channels.py:146-172 in the port: the same fixed
    point as the JAX package, and better than ridge."""
    rng = np.random.RandomState(0)
    N, M = 64, 48
    x0 = np.zeros(N)
    x0[: N // 3] = 1.0
    x0[N // 3: 2 * N // 3] = -0.5
    A = rng.randn(M, N) / np.sqrt(N)
    noise_var = 1e-3
    y = A @ x0 + np.sqrt(noise_var) * rng.randn(M)
    j_model = jmodels.sparse_gradient_regression(
        jnp.asarray(A), jnp.asarray(y), x_shape=(N,), grad_rho=0.1,
        noise_var=noise_var, prior_var=1.0)
    model = models.sparse_gradient_regression(
        A, y, x_shape=(N,), grad_rho=0.1, noise_var=noise_var,
        prior_var=1.0, **CPU)
    ep = tt.ExpectationPropagation(model).iterate(max_iter=200, damping=0.3)
    j_ep = jt.ExpectationPropagation(j_model)
    j_ep.iterate(max_iter=200, damping=0.3)
    assert ep.n_iter == j_ep.n_iter
    for key in ("r", "v"):
        assert_close(ep.get_variable_data("x")[key],
                     j_ep.get_variable_data("x")[key], 1e-8, what=key)
    r = ep.get_variable_data("x")["r"].numpy()
    ridge = np.linalg.solve(A.T @ A / noise_var + np.eye(N),
                            A.T @ y / noise_var)
    assert np.mean((r - x0) ** 2) < 0.5 * np.mean((ridge - x0) ** 2)


def _config_3(variables, priors, channels, N, seed=1, rho=0.04,
              noise_var=1e-2, **dkw):
    """BASELINE config 3's student (bench.py:546-566) built from one
    package's modules, with its teacher x0 (numpy)."""
    rng = np.random.RandomState(seed)
    z0 = (rng.rand(1, N) < rho) * rng.randn(1, N)
    x0 = z0.ravel().cumsum()
    x0 = x0 - x0.mean()
    y = x0 + np.sqrt(noise_var) * rng.randn(N)
    student = (
        priors.GaussianPrior(size=(N,), **dkw) @
        variables.SIMOVariable(id="x", n_next=2) @ (
            channels.GaussianChannel(var=noise_var)
            @ variables.SILeafVariable(id="y") + (
                channels.GradientChannel(shape=(N,), **dkw) +
                priors.GaussBernoulliPrior(size=(1, N), rho=rho, **dkw)
            ) @ variables.MILeafVariable(id="z", n_prev=2)
        )
    ).to_model()
    return student, y, x0


def test_config_3_student_solve():
    "BASELINE config 3 at N = 64 (rho 0.1): EPSolver against JAX."
    import tramp_tpu.variables as jv
    import tramp_tpu.priors as jp
    import tramp_tpu.channels as jc
    import tramp_tpu_torch.variables as tv
    import tramp_tpu_torch.priors as tp
    import tramp_tpu_torch.channels as tc
    j_model, y, x0 = _config_3(jv, jp, jc, 64, rho=0.1)
    model, _, _ = _config_3(tv, tp, tc, 64, rho=0.1, **CPU)
    j_student = j_model.to_observed({"y": jnp.asarray(y)})
    student = model.to_observed({"y": torch.as_tensor(y, dtype=F64)})
    kw = dict(damping=0.1, max_iter=1000, tol=1e-6)
    post, n, j_post, j_n = _solve_both(j_student, student, kw)
    assert n == j_n
    for key in ("r", "v"):
        assert_close(post["x"][key], j_post["x"][key], 1e-8, what=key)
    mse = float(np.mean((post["x"]["r"].numpy() - x0) ** 2))
    assert mse < 1e-2 * float(np.mean(x0**2)) + 1e-2, mse
