"""The gallery's EP entry points against the JAX package on the same
instances: the JAX package draws the instance (its glm_generative and
scenario, or the JAX script's own builder), ``torch_parity.port_model``
carries it over, and the port's script function solves it.

- compressed_sensing's and perceptron's ``solve_ep`` + ``ep_columns``
  against ``scenario.run_ep`` with the JAX script's arguments, float64:
  equal n_iter, x's posterior mean rtol 1e-8 (floored at rtol x its largest
  magnitude), v_EP and mse_EP rtol 1e-8;
- a batch of state-evolution models whose hyperparameters are all equal
  (a grid of one point, or of repeated points), as the figures' SE grids
  can be: ``SESolver.solve_batch`` of ``stack_models`` against the JAX
  package's of ``stack_pytrees``, v rtol 1e-10 and equal n_iter per lane
  (before the repair the port's stack gave no lanes and raised);
- sparse_regression's ``ep_batch``, one alpha and 3 seeds as the lanes of
  one ``EPSolver.solve_batch`` (an operator per lane), against the JAX
  package's ``EPSolver.solve_batch`` of ``stack_pytrees``: equal n_iter per
  lane, r within 1e-3 of the largest |r| (the batch tolerance: a lane of a
  batched product sums in another order), each seed's mse rtol 1e-6;
- ``scenario.setup(seed)`` samples the teacher apart from a generator
  seeded with ``seed``, as the JAX package's split keys do: the teacher's
  x, under a Gaussian prior, is not the operator's first numbers nor
  correlated with any of its rows (|cosine| < 0.5, where independent
  rows of 200 give about 0.07 and the shared stream gave 1), and the same
  seed gives the same sample;
  (fast_paths: tests/test_torch_examples_fast_paths.py).
"""
import jax
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu.experiments import BayesOptimalScenario as JScenario
from tramp_tpu.parallel import EPSolver as JEPSolver, stack_pytrees as jstack

from tramp_tpu_torch import glm_generative
from tramp_tpu_torch.experiments import BayesOptimalScenario
from tramp_tpu_torch.examples import _cli
from tramp_tpu_torch.examples.glm import compressed_sensing, perceptron
from tramp_tpu_torch.examples.figures import sparse_regression

from torch_parity import assert_close, port_model, to_numpy

RTOL = 1e-8
BATCH_RTOL = 1e-3


def _jax_scenario(N, alpha, seed, **kwargs):
    model = jt.glm_generative(N=N, alpha=alpha, ensemble_type="gaussian",
                              key=jax.random.PRNGKey(seed), **kwargs)
    scenario = JScenario(model, x_ids=["x"])
    scenario.setup(seed=seed)
    return scenario


@pytest.mark.parametrize("module,kwargs,ep_kwargs", [
    (compressed_sensing,
     dict(prior_type="gauss_bernoulli", output_type="gaussian",
          prior_rho=0.25, output_var=1e-2), dict(max_iter=250, damping=0.1)),
    (perceptron, dict(prior_type="binary", output_type="sgn"),
     dict(max_iter=250)),
], ids=["compressed_sensing", "perceptron"])
def test_ep_columns_against_jax(module, kwargs, ep_kwargs):
    assert module.EP_ITERATE == ep_kwargs
    scenario = _jax_scenario(N=120, alpha=0.6, seed=0, **kwargs)
    j = scenario.run_ep(**ep_kwargs)
    x_true = np.asarray(scenario.x_true["x"])
    ep = module.solve_ep(port_model(scenario.student))
    assert ep.n_iter == int(j["n_iter"])
    assert_close(ep.get_variable_data("x")["r"], j["x"]["r"], RTOL, "r")
    cols = compressed_sensing.ep_columns(ep, torch.tensor(x_true))
    np.testing.assert_allclose(cols["v_EP"], float(np.mean(j["x"]["v"])),
                               rtol=RTOL)
    mse = float(np.mean((np.asarray(j["x"]["r"]) - x_true) ** 2))
    np.testing.assert_allclose(cols["mse_EP"], mse, rtol=RTOL)


@pytest.mark.parametrize("points", [1, 3])
def test_se_batch_of_equal_points_against_jax(points):
    from tramp_tpu.parallel import SESolver as JSESolver
    from tramp_tpu_torch import glm_state_evolution
    from tramp_tpu_torch.parallel import SESolver, stack_models
    kw = dict(alpha=0.5, prior_type="gauss_bernoulli",
              output_type="gaussian", prior_rho=0.3, output_var=1e-2)
    jm = jt.glm_state_evolution(**kw)
    j_post, j_n = JSESolver(jm, **sparse_regression.SE_SOLVE).solve_batch(
        jstack([jm] * points))
    m = glm_state_evolution(**kw)
    post, n_iter = SESolver(m, device="cpu", **sparse_regression.SE_SOLVE) \
        .solve_batch(stack_models([m] * points, device="cpu"))
    assert np.array_equal(to_numpy(n_iter), np.asarray(j_n))
    np.testing.assert_allclose(to_numpy(post["x"]["v"]).reshape(points),
                               np.asarray(j_post["x"]["v"]).reshape(points),
                               rtol=1e-10)


def test_sparse_regression_ep_batch_against_jax():
    from tramp_tpu.algos.metrics import mean_squared_error
    alpha, N, seeds = 0.6, 100, 3
    scenarios = [_jax_scenario(
        N, alpha, seed, prior_type="gauss_bernoulli",
        output_type="gaussian", prior_rho=sparse_regression.RHO,
        output_var=sparse_regression.NOISE_VAR) for seed in range(seeds)]
    students = [sc.student for sc in scenarios]
    x_true = [np.asarray(sc.x_true["x"]) for sc in scenarios]
    post, n_iter = JEPSolver(students[0], **sparse_regression.EP_SOLVE) \
        .solve_batch(jstack(students))
    mses, p_post, p_n_iter = sparse_regression.ep_batch(
        [port_model(s) for s in students],
        [torch.tensor(x) for x in x_true])
    assert np.array_equal(to_numpy(p_n_iter), np.asarray(n_iter))
    assert_close(p_post["x"]["r"], post["x"]["r"], BATCH_RTOL, "r")
    want = [mean_squared_error(x_true[i], np.asarray(post["x"]["r"])[i])
            for i in range(seeds)]
    np.testing.assert_allclose(mses, want, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_setup_samples_apart_from_the_operator_stream(seed):
    N, cpu = 200, torch.device("cpu")
    model = glm_generative(
        N=N, alpha=0.5, ensemble_type="gaussian", prior_type="gaussian",
        output_type="gaussian", output_var=1e-2,
        generator=_cli.generator(cpu, seed), device=cpu, dtype=torch.float64)
    W = model.factors[1].W
    scenario = BayesOptimalScenario(model, x_ids=["x"])
    scenario.setup(seed=seed)
    x = scenario.x_true["x"]
    first = torch.randn(N, generator=_cli.generator(cpu, seed),
                        dtype=torch.float64)
    assert not torch.allclose(x, first)
    cosine = (W @ x) / (W.norm(dim=1) * x.norm())
    assert float(cosine.abs().max()) < 0.5
    scenario.setup(seed=seed)
    assert torch.equal(scenario.x_true["x"], x)
