"""The fast solvers in the reduced-precision mode against the JAX package
(ROADMAP Queue 3, parity gap 2), and pinned constant messages through a
batched solve.

- ``dispatch_solver`` with ``MATVEC_BF16`` on, the JAX side without x64
  (under x64 its float32 models carry float64 precisions and another bf16
  trajectory: ROADMAP Queue 3): on an N = 256 float32 GLM (a
  ``SpectralVAMPSolver``) and a relu GLM (an ``MLVAMPSolver``) at tol
  1e-4, the same solver class in both packages, n_iter within 2 (or both
  at max_iter: the relu GLM does not converge with bf16 products in either
  package), and the mean posterior variance of x within 5e-3 relative.
  The ROADMAP re-anchor's check of the same cases read n_iter 14 / 13 and
  300 / 300 and mean v within 2.4e-3 and 8.6e-4. Below tol 1e-4 the stop
  iteration is set by the rounding of the bf16 products, not by the
  contraction: on three seeds at tol 1e-5 and 1e-6 the two packages
  stopped at 21 / 28, 26 / 24, 30 / 44 and 42 / 85, 42 / 26, 57 / 63
  iterations, with r within 6.1e-3 of the largest |r| (bfloat16's
  resolution) and equal counts without bf16 (ROADMAP Queue 3).
- ``PIN_CONSTANT_MESSAGES`` through ``EPSolver.solve_batch``, 4 lanes of
  an N = 128 float64 GLM with an operator and observation each: equal
  n_iter per lane, r within rtol 1e-8 of the largest |r| (the re-anchor
  read 9.2e-16), and every lane equal to its single pinned solve.
"""
import jax
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import config as jconfig
from tramp_tpu.channels import GaussianChannel as JGaussianChannel
from tramp_tpu.channels import LinearChannel as JLinear
from tramp_tpu.channels import ReluChannel as JReluChannel
from tramp_tpu.parallel import (
    EPSolver as JEPSolver, dispatch_solver as jdispatch,
    stack_pytrees as jstack)
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

from tramp_tpu_torch import config
from tramp_tpu_torch.parallel import EPSolver, dispatch_solver, stack_models

from torch_parity import assert_close, port_model, to_numpy

V_RTOL = 5e-3
SOLVE = dict(max_iter=300, tol=1e-4)


def _glm(N, alpha=0.6, rho=0.3, noise_var=1e-2, seed=0, dtype=np.float32,
         relu=False):
    "A JAX student from numpy: x -> W -> z [-> relu -> a] -> + noise -> y."
    import jax.numpy as jnp
    rng = np.random.RandomState(seed)
    M = int(alpha * N)
    W = (rng.randn(M, N) / np.sqrt(N)).astype(dtype)
    x = ((rng.rand(N) < rho) * rng.randn(N)).astype(dtype)
    z = np.maximum(W @ x, 0) if relu else W @ x
    y = (z + np.sqrt(noise_var) * rng.randn(M)).astype(dtype)
    m = JGaussBernoulliPrior(size=N, rho=rho) @ jt.V(id="x") @ \
        JLinear(jnp.asarray(W)) @ jt.V(id="z")
    if relu:
        m = m @ JReluChannel() @ jt.V(id="a")
    m = (m @ JGaussianChannel(var=noise_var) @ jt.O(id="y")).to_model()
    return m.to_observed({"y": jnp.asarray(y)})


@pytest.mark.parametrize("relu,cls", [(False, "SpectralVAMPSolver"),
                                      (True, "MLVAMPSolver")],
                         ids=["glm", "relu"])
def test_dispatched_solver_with_bf16_products_against_jax(relu, cls,
                                                          monkeypatch):
    monkeypatch.setattr(config, "MATVEC_BF16", True)
    monkeypatch.setattr(jconfig, "MATVEC_BF16", True)
    kw = dict(SOLVE, damping=0.1) if relu else SOLVE
    with jax.enable_x64(False):
        jmodel = _glm(256, relu=relu)
        jsolver = jdispatch(jmodel, **kw)
        j_post, j_n = jsolver.solve(jmodel)
        jv = float(np.mean(np.asarray(j_post["x"]["v"], np.float64)))
        model = port_model(jmodel, dtype=torch.float32)
    solver = dispatch_solver(model, **kw)
    post, n_iter = solver.solve(model)
    assert type(solver).__name__ == type(jsolver).__name__ == cls
    assert abs(int(n_iter) - int(j_n)) <= 2 or \
        int(n_iter) == int(j_n) == SOLVE["max_iter"]
    r = post["x"]["r"]
    assert r.dtype == torch.float32 and torch.isfinite(r).all()
    v = float(post["x"]["v"].double().mean())
    assert abs(v - jv) <= V_RTOL * jv, (v, jv)


def test_pinned_messages_through_a_batched_solve(monkeypatch):
    monkeypatch.setattr(config, "PIN_CONSTANT_MESSAGES", True)
    monkeypatch.setattr(jconfig, "PIN_CONSTANT_MESSAGES", True)
    jmodels = [_glm(128, alpha=0.7, seed=s, dtype=np.float64)
               for s in range(4)]
    kw = dict(damping=0.1, max_iter=300, tol=1e-8)
    j_post, j_n = JEPSolver(jmodels[0], **kw).solve_batch(jstack(jmodels))
    models = [port_model(m) for m in jmodels]
    for m in models:
        # the converter makes arrays, not the device a prior builds its
        # constant message on: the one a user gives the prior
        m.factors[0].device, m.factors[0].dtype = "cpu", torch.float64
    solver = EPSolver(models[0], **kw)
    assert solver.engine.pinned
    post, n_iter = solver.solve_batch(stack_models(models))
    assert np.array_equal(to_numpy(n_iter), np.asarray(j_n))
    assert_close(post["x"]["r"], j_post["x"]["r"], 1e-8, "r")
    for i, m in enumerate(models):
        one, n_one = EPSolver(m, **kw).solve(m)
        assert int(n_one) == int(to_numpy(n_iter)[i])
        assert_close(post["x"]["r"][i], one["x"]["r"], 1e-8, f"lane {i}")
