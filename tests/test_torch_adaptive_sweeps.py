"""``damping="adaptive"`` in tramp_tpu_torch against tramp_tpu sweep by
sweep, float64 on the CPU: the GLM of tests/test_ep_glm.py:141-147 at
N = 64 and a relu net at N = 64 (whose objective runs through the relu
factor's log-partition, the five-output kernel's plain twin on the CPU),
one sweep at a time from warm starts, and the state evolution's adaptive
path (StateEvolution inherits it through its node objectives).

Tolerance: states and v rtol 1e-8. Every accept decision matches on these
instances (a flipped decision would move a message by half its step, far
beyond the tolerance); the states differ by summation order only.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import tramp_tpu as jt
from tramp_tpu import channels as jchannels
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import tramp_tpu_torch as tt

from torch_parity import (
    assert_close, assert_states_close, glm_scenario, port_model,
)

RTOL = 1e-8


def _relu_net(N=64, alpha=0.75, seed=1):
    "prior -> W -> relu -> + noise -> y at N = 64, data from numpy."
    rng = np.random.RandomState(seed)
    M = int(alpha * N)
    W = rng.randn(M, N) / np.sqrt(N)
    x0 = (rng.rand(N) < 0.3) * rng.randn(N)
    y = np.maximum(W @ x0, 0.0) + 0.1 * rng.randn(M)
    dag = (JGaussBernoulliPrior(size=N, rho=0.3) @ jt.V(id="x")
           @ jchannels.LinearChannel(jnp.asarray(W), name="W")
           @ jt.V(id="z") @ jchannels.ReluChannel() @ jt.V(id="a")
           @ jchannels.GaussianChannel(var=1e-2) @ jt.O(id="y"))
    return dag.to_model().to_observed({"y": jnp.asarray(y)})


@pytest.mark.parametrize("kind", ["glm", "relu_net"])
def test_adaptive_sweep_by_sweep_against_jax(kind):
    "One sweep at a time (warm starts), each state held against JAX's."
    j_student = (glm_scenario(N=64).student if kind == "glm"
                 else _relu_net())
    ep = tt.ExpectationPropagation(port_model(j_student))
    j_ep = jt.ExpectationPropagation(j_student)
    never = lambda algo, i, m: False   # noqa: E731
    for sweep in range(8):
        ep.iterate(max_iter=1, damping="adaptive", callback=never,
                   warm_start=sweep > 0)
        j_ep.iterate(max_iter=1, damping="adaptive", callback=never,
                     warm_start=sweep > 0)
        assert ep.n_iter == j_ep.n_iter == sweep + 1
        assert_states_close(ep.state, j_ep.state, ep.n_slots, RTOL,
                            what=f"{kind} sweep {sweep}")


def test_adaptive_state_evolution_matches_jax():
    "StateEvolution inherits the path: its node objectives score it."
    kw = dict(prior_type="gauss_bernoulli", output_type="gaussian",
              prior_rho=0.25, output_var=1e-2)
    se = tt.StateEvolution(tt.glm_state_evolution(alpha=0.6, **kw),
                           device="cpu")
    j_se = jt.StateEvolution(jt.glm_state_evolution(alpha=0.6, **kw))
    se.iterate(max_iter=30, damping="adaptive")
    j_se.iterate(max_iter=30, damping="adaptive")
    assert se.n_iter == j_se.n_iter
    for id in ("x", "z"):
        assert_close(se.get_variable_data(id)["v"],
                     j_se.get_variable_data(id)["v"], RTOL, what=id)


def test_adaptive_state_evolution_derives_the_second_moments_once():
    """An adaptive SE run hands the second moments it derived once to every
    objective it scores (132 per sweep on this net), and reaches the bits
    of objectives that derive them anew each time."""
    student = port_model(_relu_net())

    class Counting(tt.StateEvolution):
        prepares = 0

        def _prepare(self, model):
            self.prepares += 1
            return super()._prepare(model)

    class Anew(tt.StateEvolution):
        def node_objective_at(self, i, state, aux=None):
            return super().node_objective_at(i, state)

        def variable_objective(self, var, v_idx, post, aux=None):
            return super().variable_objective(var, v_idx, post)

    se = Counting(student, device="cpu").iterate(
        max_iter=4, damping="adaptive", tol=0.0)
    anew = Anew(student, device="cpu").iterate(
        max_iter=4, damping="adaptive", tol=0.0)
    assert se.prepares == 1
    assert se.n_iter == anew.n_iter == 4
    for id in ("x", "z", "a"):
        v, v_anew = (e.get_variable_data(id)["v"] for e in (se, anew))
        assert float(v) > 0 and float(v) == float(v_anew), id
