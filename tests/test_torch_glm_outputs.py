"""The GLMs the remaining factors open, tramp_tpu_torch against tramp_tpu,
float64 on the CPU: ``glm_state_evolution`` with relu, abs (sign
retrieval), sgn (the perceptron, binary prior), door (binary prior) and
modulus (phase retrieval) outputs, 4 SE sweeps from an informed start
against JAX (the door's in tests/test_torch_pl_likelihood_se_door.py),
and a 3-lane ``SESolver.solve_batch`` of each against its
single solves. Their EP side (the perceptron, ``channel2likelihood``) is
in tests/test_torch_glm_outputs_ep.py. The full golden solves are not run
here (the chip's smoke run holds them).

Tolerances (torch_parity.assert_close):
- the SE state after 4 sweeps, slot by slot: rtol 1e-9 (the quadratures
  summed in another order);
- lanes of a batched SE solve against their single solves: v at rtol
  1e-10, equal n_iter.
"""
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import algos as jalgos

import tramp_tpu_torch as tt
from tramp_tpu_torch import algos, parallel

from torch_parity import assert_close

F64 = torch.float64
SE_RTOL = 1e-9
# (builder keywords, informed start a0): one model per output type
GLMS = {
    "relu": (dict(prior_type="gauss_bernoulli", output_type="relu",
                  prior_rho=0.4, prior_mean=0.0, alpha=1.0), 0.0),
    "abs": (dict(prior_type="gauss_bernoulli", output_type="abs",
                 prior_rho=0.4, prior_mean=0.0, alpha=1.0), 0.1),
    "sgn": (dict(prior_type="binary", output_type="sgn", prior_p_pos=0.25,
                 alpha=0.8), 0.0),
    "door": (dict(prior_type="binary", output_type="door", prior_p_pos=0.51,
                  output_width=0.5, alpha=1.5), 0.1),
    "modulus": (dict(prior_type="gauss_bernoulli", output_type="modulus",
                     prior_rho=0.4, prior_mean=0.0, alpha=1.5), 0.1),
}


def _never(algo, i, max_iter):
    return False


def check_sweeps(name):
    """4 sweeps of the callback loop (one jitted sweep on the JAX side):
    every slot's precision and v of x and z."""
    kw, a0 = GLMS[name]
    se = tt.StateEvolution(tt.glm_state_evolution(**kw), device="cpu")
    se.iterate(max_iter=4, callback=_never,
               initializer=algos.CustomInit(a_init=[("x", "bwd", a0)]))
    j_se = jt.StateEvolution(jt.glm_state_evolution(**kw))
    j_se.iterate(max_iter=4, callback=_never,
                 initializer=jalgos.CustomInit(a_init=[("x", "bwd", a0)]))
    assert se.n_iter == j_se.n_iter == 4
    assert len(se.state) == len(j_se.state)
    for s, (got, want) in enumerate(zip(se.state, j_se.state)):
        assert got["a"].dtype == F64
        assert_close(got["a"], want["a"], SE_RTOL, what=f"slot {s}")
    for id in ("x", "z"):
        assert_close(se.get_variable_data(id)["v"],
                     j_se.get_variable_data(id)["v"], SE_RTOL, what=id)


# the door GLM's sweeps are in tests/test_torch_pl_likelihood_se_door.py:
# its JAX sweep compiles for seconds, which this file has no room for
@pytest.mark.parametrize("name", ["relu", "abs", "sgn", "modulus"])
def test_glm_state_evolution_sweeps_match_jax(name):
    check_sweeps(name)


# the lanes' hyperparameters: alpha per lane, and the prior's per lane
LANE_GRIDS = {
    "relu": dict(alpha=[0.5, 1.0, 1.6], prior_rho=[0.2, 0.4, 0.6]),
    "abs": dict(alpha=[0.4, 1.0, 1.5], prior_rho=[0.2, 0.4, 0.4]),
    "sgn": dict(alpha=[0.3, 0.8, 1.2], prior_p_pos=[0.25, 0.5, 0.25]),
    "door": dict(alpha=[1.0, 1.5, 2.5], prior_p_pos=[0.51, 0.51, 0.6]),
    "modulus": dict(alpha=[0.5, 1.5, 2.5], prior_rho=[0.4, 0.4, 0.6]),
}


@pytest.mark.parametrize("name", list(GLMS))
def test_glm_solve_batch_lanes_equal_single_solves(name):
    """Three lanes, each with its own alpha, prior hyperparameter and
    informed start (the per-lane initializer list), in one
    ``SESolver.solve_batch``: each lane is its single solve."""
    kw, _ = GLMS[name]
    grid = LANE_GRIDS[name]
    a0s = [0.0, 0.1, 1000.0]
    models = [tt.glm_state_evolution(**dict(
        kw, **{k: v[i] for k, v in grid.items()})) for i in range(3)]
    stacked = parallel.stack_models(models, device="cpu")
    inits = [algos.CustomInit(a_init=[("x", "bwd", a0)]) for a0 in a0s]
    solver = parallel.SESolver(models[0], max_iter=15, device="cpu")
    post, n_iter = solver.solve_batch(stacked, inits)
    assert post["x"]["v"].shape == n_iter.shape == (3,)
    for i in range(3):
        one, n_one = solver.solve(models[i], inits[i])
        assert int(n_iter[i]) == int(n_one), i
        np.testing.assert_allclose(float(post["x"]["v"][i]),
                                   float(one["x"]["v"]), rtol=1e-10)
