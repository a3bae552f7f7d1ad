"""The engine's checkpoints, ``run_trace`` and ``update_dA`` in
tramp_tpu_torch against tramp_tpu, float64 on the CPU: the counterparts of
tests/test_ep_glm.py:166-218 (save / load / resume equals the run that was
not interrupted; ``run_trace`` equals a TrackEvolution callback's v curve)
and tests/test_spectral_carry.py:151-180 (the round trip keeps the carried
images; a checkpoint without them rebuilds them from the slots), then a
checkpoint written by either package resumed in the other, ``self.dA``
slot by slot against JAX's, and ``parallel.save_checkpoint`` /
``restore_checkpoint`` around the batched solvers.

Tolerances: within the port, resumes and round trips are bit-identical and
``run_trace`` meets the callback's curve at rtol 1e-10
(tests/test_ep_glm.py:218); across the packages, a resumed r at rtol 1e-10
of the other package's continuation, traces and dA at rtol 1e-8 (dA is a
difference of objectives: the floor is rtol times the largest |dA|).
"""
import numpy as np
import pytest
import torch

import tramp_tpu as jt

import tramp_tpu_torch as tt
from tramp_tpu_torch import algos, parallel
from tramp_tpu_torch.channels import (
    GaussianChannel, LinearChannel, ReluChannel,
)
from tramp_tpu_torch.priors import GaussBernoulliPrior

from torch_parity import assert_close, glm_scenario, port_model

SOLVE = dict(damping=0.1, tol=0.0)


def _students():
    "(JAX, port) students of tests/test_ep_glm.py:168-173's GLM."
    j_student = glm_scenario(N=80, prior_rho=0.4, key=5, seed=2).student
    return j_student, port_model(j_student)


def _assert_states_equal(a, b):
    assert len(a) == len(b)
    for m_a, m_b in zip(a, b):
        assert set(m_a) == set(m_b)
        for k in m_a:
            assert torch.equal(m_a[k], m_b[k]), k


def test_save_load_resume_is_bit_identical(tmp_path):
    _, student = _students()
    path = str(tmp_path / "ckpt.npz")
    ep1 = tt.ExpectationPropagation(student)
    ep1.iterate(max_iter=5, **SOLVE)
    ep1.save_state(path)
    keys = set(np.load(path).files)
    assert {"__n_iter__", "s0_a", "s0_b"} <= keys
    assert [k for k in keys if k.startswith("spec_")] == [
        f"spec_{ep1.spectral_factors[0]}"]
    ep1.iterate(max_iter=10, warm_start=True, **SOLVE)
    ep2 = tt.ExpectationPropagation(student).load_state(path)
    assert ep2.n_iter == 5
    ep2.iterate(max_iter=10, warm_start=True, **SOLVE)
    assert ep2.n_iter == ep1.n_iter == 15
    _assert_states_equal(ep2.state, ep1.state)


def test_legacy_checkpoint_without_spectral_images(tmp_path, monkeypatch):
    "tests/test_spectral_carry.py:166-180: rebuilt from the slots."
    _, student = _students()
    with monkeypatch.context() as m:
        m.setattr(tt.config, "SPECTRAL_CARRY", False)
        off = tt.ExpectationPropagation(student)
    off.iterate(max_iter=12, damping=0.2, tol=0.0)
    path = str(tmp_path / "legacy.npz")
    off.save_state(path)
    assert not [k for k in np.load(path).files if k.startswith("spec_")]
    on = tt.ExpectationPropagation(student).load_state(path)
    assert on.spectral_factors
    off.iterate(max_iter=6, damping=0.2, tol=0.0, warm_start=True)
    on.iterate(max_iter=6, damping=0.2, tol=0.0, warm_start=True)
    _assert_states_equal(on.state[:on.n_slots], off.state)


def test_load_state_takes_the_engine_dtype(tmp_path):
    j_student, student = _students()
    ep = tt.ExpectationPropagation(student).iterate(max_iter=3, **SOLVE)
    path = str(tmp_path / "f64.npz")
    ep.save_state(path)
    ep32 = tt.ExpectationPropagation(port_model(j_student, torch.float32))
    ep32.load_state(path)
    assert all(v.dtype == torch.float32 for m in ep32.state
               for v in m.values())
    ep32.iterate(max_iter=3, warm_start=True, **SOLVE)
    assert ep32.n_iter == 6


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """The shared .npz layout: 5 sweeps in one package, saved, loaded by
    the other, 10 more sweeps there against the writer's own 10."""
    j_student, student = _students()
    path = str(tmp_path / f"{writer}.npz")
    ep, j_ep = (tt.ExpectationPropagation(student),
                jt.ExpectationPropagation(j_student))
    first, second = (j_ep, ep) if writer == "jax" else (ep, j_ep)
    first.iterate(max_iter=5, **SOLVE)
    first.save_state(path)
    second.load_state(path)
    assert second.n_iter == 5
    for engine in (first, second):
        engine.iterate(max_iter=10, warm_start=True, **SOLVE)
    assert ep.n_iter == j_ep.n_iter == 15
    for id in ("x", "z"):
        assert_close(ep.get_variable_data(id)["r"],
                     j_ep.get_variable_data(id)["r"], 1e-10, what=id)


def test_run_trace_matches_the_callback_and_jax():
    "tests/test_ep_glm.py:194-218, and the JAX package's run_trace."
    j_student = glm_scenario(N=60, alpha=0.7, prior_rho=0.4, key=8,
                             seed=4).student
    student = port_model(j_student)
    n_iter = 8
    ep1 = tt.ExpectationPropagation(student)
    trace = ep1.run_trace(n_iter=n_iter, damping=0.1)
    assert set(trace) == {"x", "z"} and trace["x"].shape == (n_iter,)
    assert ep1.n_iter == n_iter
    ep2 = tt.ExpectationPropagation(student)
    track = algos.TrackEvolution()
    ep2.iterate(max_iter=n_iter, damping=0.1, callback=track)
    v_cb = [r["v"] for r in track.records if r["id"] == "x"]
    np.testing.assert_allclose(trace["x"].numpy(), v_cb, rtol=1e-10)
    _assert_states_equal(ep1.state, ep2.state)
    j_trace = jt.ExpectationPropagation(j_student).run_trace(
        n_iter=n_iter, damping=0.1)
    for id in ("x", "z"):
        assert_close(trace[id], j_trace[id], 1e-8, what=id)
    # a warm-started trace continues the state like iterate(warm_start)
    more = ep1.run_trace(n_iter=3, damping=0.1, warm_start=True)
    ep2.iterate(max_iter=3, damping=0.1, warm_start=True, tol=0.0)
    assert ep1.n_iter == ep2.n_iter == n_iter + 3 and more["x"].shape == (3,)
    _assert_states_equal(ep1.state, ep2.state)


@pytest.mark.parametrize("damping", [0.1, "adaptive"])
def test_update_dA_matches_jax_slot_by_slot(damping):
    j_student, student = _students()
    ep = tt.ExpectationPropagation(student)
    j_ep = jt.ExpectationPropagation(j_student)
    for sweeps in (1, 3):
        ep.iterate(max_iter=sweeps, damping=damping, update_dA=True)
        j_ep.iterate(max_iter=sweeps, damping=damping, update_dA=True)
        assert ep.n_iter == j_ep.n_iter == sweeps
        assert set(ep.dA) == set(j_ep.dA) == set(range(ep.n_slots))
        slots = sorted(ep.dA)
        dA = np.array([ep.dA[s] for s in slots])
        j_dA = np.array([j_ep.dA[s] for s in slots])
        # the first sweep leaves the zero-precision start: an edge's
        # objective there is infinite in both packages
        finite = np.isfinite(j_dA)
        np.testing.assert_array_equal(np.isfinite(dA), finite)
        assert finite.all() or sweeps == 1
        assert_close(dA[finite], j_dA[finite], 1e-8,
                     what=f"dA after {sweeps} sweeps")
    # update_dA takes the callback loop; the state is the loop's
    plain = tt.ExpectationPropagation(student)
    plain.iterate(max_iter=3, damping=damping, tol=0.0)
    _assert_states_equal(plain.state, ep.state)


def _batch(kind, lanes=4, N=64, M=48):
    "A stacked port model of ``lanes`` instances, data from numpy."
    models = []
    for lane in range(lanes):
        rng = np.random.RandomState(lane)
        W = rng.randn(M, N) / np.sqrt(N)
        x0 = (rng.rand(N) < 0.2) * rng.randn(N)
        z = W @ x0
        kw = dict(device="cpu", dtype=torch.float64)
        dag = (GaussBernoulliPrior(size=N, rho=0.2, **kw) @ tt.V(id="x")
               @ LinearChannel(W, name="W", **kw) @ tt.V(id="z"))
        if kind == "relu_net":
            z = np.maximum(z, 0.0)
            dag = dag @ ReluChannel() @ tt.V(id="a")
        y = torch.as_tensor(z + 0.1 * rng.randn(M), dtype=torch.float64)
        dag = dag @ GaussianChannel(var=1e-2) @ tt.O(id="y")
        models.append(dag.to_model().to_observed({"y": y}))
    return models, parallel.stack_models(models)


@pytest.mark.parametrize("solver_cls", ["EPSolver", "MLVAMPSolver"])
def test_batched_checkpoint_round_trip(tmp_path, solver_cls):
    """tests/test_parallel.py:236-280: 7 iterations, checkpoint, restore,
    resume: the restored state has the bits and the device of the saved
    one, and the resumed solve ends where one solve ends (rollback
    disabled, as there: its window restarts at a resume)."""
    models, stacked = _batch("relu_net")
    cls = getattr(parallel, solver_cls)
    kw = dict(damping=0.1, tol=1e-8)
    if solver_cls == "EPSolver":
        kw["rollback_increase"] = float("inf")
    post, n_full = cls(models[0], max_iter=300, **kw).solve_batch(stacked)
    _, state7, n7 = cls(models[0], max_iter=7, **kw).solve_batch_with_state(
        stacked)
    assert n7.tolist() == [7] * 4
    path = parallel.save_checkpoint(tmp_path / "ckpt", state7, n7)
    state_r, n_r = parallel.restore_checkpoint(path, like=(state7, n7))
    assert torch.equal(n_r, n7)
    flat = parallel.checkpoint._flatten
    a, b = flat(state_r, "", {}), flat(state7, "", {})
    assert set(a) == set(b) and len(a) > 4
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype, k
    post_r, n_rest = cls(models[0], max_iter=293, **kw).solve_batch(
        stacked, state=state_r)
    assert (n_rest + 7).tolist() == n_full.tolist()
    for vid in post:
        for key in ("r", "v"):
            assert torch.equal(post_r[vid][key], post[vid][key]), (vid, key)
    with pytest.raises(ValueError, match="structure"):
        parallel.restore_checkpoint(path, like=(state7[:1], n7))
