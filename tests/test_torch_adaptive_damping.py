"""``damping="adaptive"`` (Bethe backtracking, tramp_tpu/algos/
message_passing.py:346-392) in tramp_tpu_torch against tramp_tpu, float64
on the CPU: the counterparts of tests/test_ep_glm.py:132-160 and 220-250
(the objective ascends after the undamped first sweep; the loop without
callback and the callback loop reach one state, bit for bit) and of
tests/test_spectral_carry.py:122-127 (the same trajectory with and without
the carried spectral image). Port against JAX sweep by sweep, on this GLM,
a small relu net and the state evolution, is in
tests/test_torch_adaptive_sweeps.py.

Tolerances: states rtol 1e-8 against JAX (every accept decision of this
instance matches: its margins are far above rounding, so the states differ
by summation order only); objectives rtol 1e-10; the port's two loops and
its carry / no-carry engines exactly.
"""
import numpy as np
import torch

import tramp_tpu as jt

import tramp_tpu_torch as tt

from torch_parity import (
    assert_states_close, glm_scenario, port_model,
)

RTOL = 1e-8


def test_adaptive_objective_ascends_and_matches_jax():
    scenario = glm_scenario()
    student = port_model(scenario.student)
    objectives, j_objectives = [], []

    def track(into):
        def callback(algo, i, max_iter):
            into.append(float(algo.log_evidence()))
            return False
        return callback

    ep = tt.ExpectationPropagation(student)
    ep.iterate(max_iter=10, damping="adaptive", callback=track(objectives))
    j_ep = jt.ExpectationPropagation(scenario.student)
    j_ep.iterate(max_iter=10, damping="adaptive",
                 callback=track(j_objectives))
    assert ep.n_iter == j_ep.n_iter == 10
    assert np.all(np.isfinite(objectives))
    # monotone ascent after the first (undamped) sweep
    assert np.all(np.diff(objectives[1:]) >= -1e-8), objectives
    np.testing.assert_allclose(objectives, j_objectives, rtol=1e-10)
    assert_states_close(ep.state, j_ep.state, ep.n_slots, RTOL)
    r = ep.get_variable_data("x")["r"].numpy()
    assert float(np.mean((r - np.asarray(scenario.x_true["x"])) ** 2)) < 0.25


def test_adaptive_loop_without_callback_matches_the_callback_loop():
    student = port_model(glm_scenario().student)
    n_iter = 12
    fused = tt.ExpectationPropagation(student)
    fused.iterate(max_iter=n_iter, damping="adaptive", tol=0.0)
    py = tt.ExpectationPropagation(student)
    py.iterate(max_iter=n_iter, damping="adaptive",
               callback=lambda algo, i, m: False)
    assert fused.n_iter == py.n_iter == n_iter
    for m_f, m_p in zip(fused.state, py.state):
        for k in m_f:
            assert torch.equal(m_f[k], m_p[k]), k


def test_adaptive_with_and_without_the_carry(monkeypatch):
    "tests/test_spectral_carry.py:122-127: the same bits either way."
    student = port_model(glm_scenario(N=40).student)
    on = tt.ExpectationPropagation(student)
    monkeypatch.setattr(tt.config, "SPECTRAL_CARRY", False)
    off = tt.ExpectationPropagation(student)
    assert on.spectral_factors and not off.spectral_factors
    for ep in (on, off):
        ep.iterate(max_iter=10, damping="adaptive", tol=0.0)
    for s in range(on.n_slots):
        for k in ("a", "b"):
            assert torch.equal(on.state[s][k], off.state[s][k]), (s, k)


