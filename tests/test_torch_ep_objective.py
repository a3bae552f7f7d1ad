"""What the EP engine gained with the state-evolution slice,
tramp_tpu_torch against tramp_tpu, float64 on the CPU: ``log_evidence`` (one
value per model, rtol 1e-8: sums of N log-partitions), the callback loop
(equal to the loop without callbacks, and to the JAX package's), and
``NoisyInit`` / ``CustomInit`` states with their b messages (equal to JAX's:
the same numpy draws in the engine's slot order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import algos as jalgos
from tramp_tpu import channels as jchannels
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch import algos

from torch_parity import assert_close, port_model


def _ep_student(kind, N=24, M=18, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(M, N) / np.sqrt(N)
    x0 = (rng.rand(N) < 0.3) * rng.randn(N)
    z = W @ x0
    dag = (JGaussBernoulliPrior(size=N, rho=0.3) @ jt.V(id="x")
           @ jchannels.LinearChannel(jnp.asarray(W), name="W")
           @ jt.V(id="z"))
    if kind == "relu_net":
        z = np.maximum(z, 0.0)
        dag = dag @ jchannels.ReluChannel() @ jt.V(id="a")
    dag = dag @ jchannels.GaussianChannel(var=1e-2) @ jt.O(id="y")
    y = z + 0.1 * rng.randn(M)
    return dag.to_model().to_observed({"y": jnp.asarray(y)})


def test_noisy_and_custom_init_of_an_ep_state_match_jax():
    "The b messages too, drawn in the engine's slot order."
    j_model = _ep_student("glm")
    model = port_model(j_model)
    ep, j_ep = tt.ExpectationPropagation(model), \
        jt.ExpectationPropagation(j_model)
    b0 = np.random.RandomState(1).randn(24)
    for init, j_init in (
            (algos.NoisyInit(a_mean=1.0, a_var=0.01, seed=2),
             jalgos.NoisyInit(a_mean=1.0, a_var=0.01, seed=2)),
            (algos.CustomInit(a_init=[("x", "bwd", 2.0)],
                              b_init=[("x", "fwd", b0)]),
             jalgos.CustomInit(a_init=[("x", "bwd", 2.0)],
                               b_init=[("x", "fwd", jnp.asarray(b0))]))):
        state, j_state = ep.init_state(init), j_ep.init_state(j_init)
        for s in range(ep.n_slots):
            for k in ("a", "b"):
                assert_close(state[s][k], np.asarray(j_state[s][k]), 1e-15,
                             what=f"slot {s} {k}")


@pytest.mark.parametrize("kind", ["glm", "relu_net"])
def test_ep_log_evidence_matches_jax(kind):
    j_model = _ep_student(kind)
    ep = tt.ExpectationPropagation(port_model(j_model))
    j_ep = jt.ExpectationPropagation(j_model)
    ep.iterate(max_iter=15, damping=0.1, tol=0.0)
    j_ep.iterate(max_iter=15, damping=0.1, tol=0.0)
    assert_close(ep.log_evidence(), j_ep.log_evidence(), 1e-8)
    assert float(ep.surprisal(update=False)) == -float(ep.A_model)


def test_ep_callback_loop_equals_the_loop_without_callbacks():
    j_model = _ep_student("glm", seed=1)
    model = port_model(j_model)
    plain = tt.ExpectationPropagation(model).iterate(
        max_iter=100, damping=0.1)
    x_true = {"x": torch.zeros(24, dtype=torch.float64)}
    errors, overlaps, estimate = (
        algos.TrackErrors(x_true, metrics=["mse", "overlap", "sign_mse"]),
        algos.TrackOverlaps(x_true, ids=["x"]), algos.TrackEstimate(["x"]))
    called = tt.ExpectationPropagation(model).iterate(
        max_iter=100, damping=0.1, callback=algos.JoinCallback(
            [errors, overlaps, estimate, algos.EarlyStoppingEP()]))
    assert called.n_iter == plain.n_iter > 2
    assert_close(called.get_variable_data("x")["r"],
                 plain.get_variable_data("x")["r"], 1e-13)
    assert len(errors.errors) == plain.n_iter
    r = called.get_variable_data("x")["r"]
    assert errors.errors[-1]["mse"] == pytest.approx(float((r**2).mean()))
    assert overlaps.records[-1]["q"] == pytest.approx(float((r**2).mean()))
    assert estimate.records[-1]["r"].shape == (24,)
    j_ep = jt.ExpectationPropagation(j_model).iterate(
        max_iter=100, damping=0.1, callback=jalgos.EarlyStoppingEP())
    assert called.n_iter == j_ep.n_iter
