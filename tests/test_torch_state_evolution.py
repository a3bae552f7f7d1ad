"""The state-evolution engine, tramp_tpu_torch against tramp_tpu, float64 on
the CPU: ``StateEvolution.iterate`` on the compressed-sensing GLM (full
solves: equal n_iter, v at rtol 1e-9) and on the relu-channel model (the
state after 3 sweeps, rtol 1e-9: its JAX side is quadrature-heavy); the
golden rows this slice reaches, pinned inline as in
tests/test_golden_csv.py and at its tolerances; ``CustomInit`` and
``NoisyInit`` states equal to JAX's; the callback loop equal to the loop
without callbacks; the SE objective; the second moments. The EP side of the
same engine code (callback loop, log evidence) is in
tests/test_torch_ep_objective.py.
"""
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import algos as jalgos
from tramp_tpu import channels as jchannels
from tramp_tpu.likelihoods import GaussianLikelihood as JGaussianLikelihood
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch import algos, channels
from tramp_tpu_torch.likelihoods import GaussianLikelihood
from tramp_tpu_torch.priors import GaussBernoulliPrior

from torch_parity import (
    assert_close, describe_second_moments, describe_state,
)

RTOL = 1e-9
CS = dict(prior_type="gauss_bernoulli", output_type="gaussian",
          output_var=1e-11)

# tests/test_golden_csv.py: CS_SE_ROWS (alpha, v, rtol) and the universality
# row, all at rho = 0.25
CS_SE_ROWS = [
    (0.02040816326530612, 2.449736425973765e-01, 1e-3),
    (0.40816326530612240, 5.299215508244257e-02, 1e-2),
    (0.81632653061224480, 5.553835940647028e-08, 5e-2),
    (0.02040816326530612, 0.24497364259772186, 1e-3),
]


def _init(pkg, a0):
    return pkg.CustomInit(a_init=[("x", "bwd", a0)])


def _v(se, id="x"):
    return float(np.mean(np.asarray(se.get_variable_data(id)["v"])))


@pytest.mark.parametrize("alpha,v_ref,rtol", CS_SE_ROWS)
def test_cs_goldens(alpha, v_ref, rtol):
    model = tt.glm_state_evolution(alpha=alpha, prior_rho=0.25, **CS)
    se = tt.StateEvolution(model, device="cpu")
    se.iterate(max_iter=200, initializer=_init(algos, 0))
    v = se.get_variable_data("x")["v"]
    assert v.dtype == torch.float64 and v.shape == ()
    np.testing.assert_allclose(float(v), v_ref, rtol=rtol)


@pytest.mark.parametrize("alpha,rho,a0", [
    (0.2, 0.1, 0.0), (0.5, 0.25, 0.0), (0.9, 0.5, 0.0), (0.3, 0.25, 100.0)])
def test_cs_glm_full_solve_matches_jax(alpha, rho, a0):
    kw = dict(alpha=alpha, prior_rho=rho, **CS)
    se = tt.StateEvolution(tt.glm_state_evolution(**kw), device="cpu")
    se.iterate(max_iter=200, initializer=_init(algos, a0))
    j_se = jt.StateEvolution(jt.glm_state_evolution(**kw))
    j_se.iterate(max_iter=200, initializer=_init(jalgos, a0))
    assert se.n_iter == j_se.n_iter
    for id in ("x", "z"):
        assert_close(se.get_variable_data(id)["v"],
                     j_se.get_variable_data(id)["v"], RTOL, what=id)


def _relu_models(rho=0.3, alpha=0.8, var=1e-2):
    port = (GaussBernoulliPrior(size=1, rho=rho) @ tt.V(id="x")
            @ channels.MarchenkoPasturChannel(alpha) @ tt.V(id="z")
            @ channels.ReluChannel() @ tt.V(id="a")
            @ GaussianLikelihood(y=None, var=var)).to_model()
    ref = (JGaussBernoulliPrior(size=1, rho=rho) @ jt.V(id="x")
           @ jchannels.MarchenkoPasturChannel(alpha) @ jt.V(id="z")
           @ jchannels.ReluChannel() @ jt.V(id="a")
           @ JGaussianLikelihood(y=None, var=var)).to_model()
    return port, ref


def test_relu_channel_model_state_after_three_sweeps():
    port, ref = _relu_models()
    se = tt.StateEvolution(port, device="cpu").iterate(max_iter=3, tol=0.0)
    j_se = jt.StateEvolution(ref).iterate(max_iter=3, tol=0.0)
    assert se.n_iter == j_se.n_iter == 3
    want, _ = describe_state(j_se.state, j_se.n_slots)
    for s, msg in enumerate(want):
        assert_close(se.state[s]["a"], msg["a"], RTOL, what=f"slot {s}")
    taus = describe_second_moments(ref)
    assert set(port.get_second_moments()) == set(taus)
    for id, tau in port.get_second_moments().items():
        assert_close(torch.as_tensor(tau, dtype=torch.float64), taus[id],
                     1e-12, what=id)


@pytest.mark.parametrize("kind", ["custom", "noisy"])
def test_initial_states_match_jax(kind):
    port, ref = _relu_models()
    if kind == "custom":
        args = dict(a_init=[("x", "bwd", 3.0), ("a", "fwd", 0.2)], a=0.5)
        init, j_init = algos.CustomInit(**args), jalgos.CustomInit(**args)
    else:
        args = dict(a_mean=1.0, a_var=0.04, seed=3)
        init, j_init = algos.NoisyInit(**args), jalgos.NoisyInit(**args)
    se, j_se = tt.StateEvolution(port, device="cpu"), jt.StateEvolution(ref)
    state, j_state = se.init_state(init), j_se.init_state(j_init)
    assert len(state) == len(j_state) == se.n_slots
    for s in range(se.n_slots):
        assert state[s]["a"].dtype == torch.float64
        assert_close(state[s]["a"], np.asarray(j_state[s]["a"]), 1e-15,
                     what=f"slot {s}")


def test_callback_loop_equals_the_loop_without_callbacks():
    """``iterate(callback=EarlyStopping())`` ends where ``iterate()`` ends
    (the same stop rule, applied by the callback after each sweep), and the
    tracking callbacks see every sweep."""
    model = tt.glm_state_evolution(alpha=0.5, prior_rho=0.25, **CS)
    plain = tt.StateEvolution(model, device="cpu").iterate(max_iter=200)
    track, objective, messages = (algos.TrackEvolution(),
                                  algos.TrackObjective(),
                                  algos.TrackMessages())
    called = tt.StateEvolution(model, device="cpu").iterate(
        max_iter=200, callback=algos.JoinCallback(
            [track, objective, messages, algos.LogProgress(),
             algos.PassCallback(), algos.EarlyStopping()]))
    assert called.n_iter == plain.n_iter
    assert_close(called.get_variable_data("x")["v"],
                 plain.get_variable_data("x")["v"], 1e-14)
    assert len(track.records) == 2 * plain.n_iter        # x and z
    assert len(objective.model_records) == plain.n_iter
    assert len(messages.records) == 8 * plain.n_iter     # 4 edges x 2
    assert track.records[-1] == dict(
        id="z", v=_v(called, "z"), iter=plain.n_iter - 1)
    df = track.get_dataframe()
    assert list(df.columns) == ["id", "v", "iter"]
    # against the JAX package's callback loop
    j_track = jalgos.TrackEvolution()
    j_se = jt.StateEvolution(
        jt.glm_state_evolution(alpha=0.5, prior_rho=0.25, **CS))
    j_se.iterate(max_iter=200, callback=jalgos.JoinCallback(
        [j_track, jalgos.EarlyStopping()]))
    assert called.n_iter == j_se.n_iter
    assert_close(np.array([r["v"] for r in track.records]),
                 np.array([r["v"] for r in j_track.records]), RTOL)


def test_se_objective_matches_jax():
    kw = dict(alpha=0.5, prior_rho=0.25, **CS)
    se = tt.StateEvolution(tt.glm_state_evolution(**kw), device="cpu")
    j_se = jt.StateEvolution(jt.glm_state_evolution(**kw))
    se.iterate(max_iter=5, tol=0.0)
    j_se.iterate(max_iter=5, tol=0.0)
    assert_close(se.update_objective(), j_se.update_objective(), RTOL)
    assert float(se.entropy()) == -float(se.A_model)


def test_state_evolution_dtype_and_device():
    model = tt.glm_state_evolution(alpha=0.5, prior_rho=0.25, **CS)
    se = tt.StateEvolution(model, device="cpu", dtype=torch.float32)
    se.iterate(max_iter=3)
    assert se.get_variable_data("x")["v"].dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt.StateEvolution(model)
