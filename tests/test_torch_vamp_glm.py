"""tramp_tpu_torch.parallel.SpectralVAMPSolver against
tramp_tpu.parallel.SpectralVAMPSolver, float64 on the CPU.

Instances are made with numpy from a seed; the port's model is converted
from the JAX model (tests/torch_parity.py), so both sides hold the same
arrays and the same SVD.

Tolerances (torch_parity.assert_close: relative to each element, with a
floor of rtol times the array's largest magnitude):
- one ``_step`` from a given carry: rtol 1e-10 (the same arithmetic; only
  elementwise roundoff and the products' summation order differ);
- ``solve_info`` with tol=1e-12: equal ``n_iter`` and ``conv``, r and v of
  both variables at rtol 1e-8 (that roundoff, compounded over the solve).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu.channels import (
    GaussianChannel as JGaussianChannel, LinearChannel as JLinearChannel,
    ReluChannel as JReluChannel,
)
from tramp_tpu.parallel import SpectralVAMPSolver as JSpectralVAMPSolver
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

from tramp_tpu_torch.parallel import SpectralVAMPSolver

from torch_parity import assert_close, port_model

F64 = torch.float64
SHAPES = {"N300_k_lt_Nz": (180, 300), "N200x120_k_lt_Nz": (120, 200),
          "square_k_eq_Nz": (100, 100), "tall_k_eq_Nz": (150, 100)}


def glm(M, N, seed=0, ids=("x", "z"), rho=0.3, noise=1e-2):
    "(JAX student, port student) of a compressed-sensing GLM."
    rng = np.random.RandomState(seed)
    W = rng.randn(M, N) / np.sqrt(N)
    x0 = (rng.rand(N) < rho) * rng.randn(N)
    y = W @ x0 + np.sqrt(noise) * rng.randn(M)
    student = (
        JGaussBernoulliPrior(size=N, rho=rho) @ jt.V(id=ids[0])
        @ JLinearChannel(jnp.asarray(W), name="W") @ jt.V(id=ids[1])
        @ JGaussianChannel(var=noise) @ jt.O(id="y")
    ).to_model().to_observed({"y": jnp.asarray(y)})
    return student, port_model(student)


def assert_posteriors_close(post, j_post, rtol):
    assert set(post) == set(j_post)
    for vid in j_post:
        for key in ("r", "v"):
            assert_close(post[vid][key], j_post[vid][key], rtol,
                         what=f"{vid} {key}")


@pytest.mark.parametrize("damping", [None, 0.5], ids=["undamped", "damped"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_step_matches_jax(shape, damping):
    M, N = SHAPES[shape]
    j_model, p_model = glm(M, N)
    rng = np.random.RandomState(3)
    r1, gamma1 = rng.randn(N), 0.7
    (j_r1, j_g1), (j_x1, j_v1) = JSpectralVAMPSolver(
        j_model, damping=damping)._step(
        j_model, (jnp.asarray(r1), jnp.asarray(gamma1)))
    (r1n, g1n), (x1, v1) = SpectralVAMPSolver(
        p_model, damping=damping)._step(
        p_model, (torch.as_tensor(r1), torch.tensor(gamma1, dtype=F64)))
    for what, got, want in (("r1", r1n, j_r1), ("gamma1", g1n, j_g1),
                            ("x1", x1, j_x1), ("v1", v1, j_v1)):
        assert_close(got, want, 1e-10, what=what)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_solve_info_matches_jax(shape):
    M, N = SHAPES[shape]
    j_model, p_model = glm(M, N, seed=1)
    j_post, j_n, j_conv = JSpectralVAMPSolver(
        j_model, max_iter=500, tol=1e-12).solve_info(j_model)
    post, n_iter, conv = SpectralVAMPSolver(
        p_model, max_iter=500, tol=1e-12).solve_info(p_model)
    assert int(n_iter) == int(j_n) and bool(conv) == bool(j_conv) is True
    assert_posteriors_close(post, j_post, 1e-8)
    assert post["x"]["v"].ndim == 0 and post["z"]["r"].shape == (M,)


def test_damped_solve_matches_jax():
    j_model, p_model = glm(120, 200, seed=9)
    j_post, j_n, j_conv = JSpectralVAMPSolver(
        j_model, damping=0.5, max_iter=800, tol=1e-12).solve_info(j_model)
    post, n_iter, conv = SpectralVAMPSolver(
        p_model, damping=0.5, max_iter=800, tol=1e-12).solve_info(p_model)
    assert int(n_iter) == int(j_n) and bool(conv) == bool(j_conv) is True
    assert_posteriors_close(post, j_post, 1e-8)


def test_solve_returns_the_models_variable_ids():
    "Posterior keys follow the model's ids (tests/test_vamp_glm.py:53-76)."
    j_model, p_model = glm(120, 200, seed=2, ids=("w", "zz"))
    j_post, j_n = JSpectralVAMPSolver(
        j_model, max_iter=500, tol=1e-12).solve(j_model)
    post, n_iter = SpectralVAMPSolver(
        p_model, max_iter=500, tol=1e-12).solve(p_model)
    assert set(post) == {"w", "zz"} and int(n_iter) == int(j_n)
    assert_posteriors_close(post, j_post, 1e-8)


def test_max_iter_stops_an_unconverged_solve():
    j_model, p_model = glm(120, 200)
    j_post, j_n, j_conv = JSpectralVAMPSolver(
        j_model, max_iter=3, tol=1e-12).solve_info(j_model)
    post, n_iter, conv = SpectralVAMPSolver(
        p_model, max_iter=3, tol=1e-12).solve_info(p_model)
    assert int(n_iter) == int(j_n) == 3
    assert bool(conv) is bool(j_conv) is False
    assert_posteriors_close(post, j_post, 1e-10)


def test_rejects_a_model_that_is_no_glm():
    N = 32
    rng = np.random.RandomState(0)
    W = rng.randn(16, N) / np.sqrt(N)
    student = (
        JGaussBernoulliPrior(size=N, rho=0.5) @ jt.V(id="x")
        @ JLinearChannel(jnp.asarray(W)) @ jt.V(id="z") @ JReluChannel()
        @ jt.V(id="a") @ JGaussianChannel(var=1e-2) @ jt.O(id="y")
    ).to_model().to_observed({"y": jnp.asarray(rng.randn(16))})
    with pytest.raises(ValueError, match="SpectralVAMPSolver"):
        JSpectralVAMPSolver(student)
    with pytest.raises(ValueError, match="SpectralVAMPSolver"):
        SpectralVAMPSolver(port_model(student))
