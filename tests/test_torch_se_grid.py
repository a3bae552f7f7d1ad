"""The batched state evolution and what is built on it, tramp_tpu_torch
against tramp_tpu, float64 on the CPU: ``stack_models`` on models whose
hyperparameters differ; ``SESolver.solve_batch`` over a 3 x 3 (alpha, rho)
grid against its single solves (equal n_iter, v at rtol 1e-12) and against
the JAX package's batched solve (equal n_iter, v at rtol 1e-9), with one
initializer and with one per lane; ``run_se_phase_grid`` against the JAX
package's DataFrame; the 19 critical lines of tests/test_golden_csv.py
through ``find_critical_alpha_batched``, pinned inline (atol 1e-12: the
bisection returns points of a discrete schedule) and one of them through the
sequential ``find_critical_alpha``; ``BayesOptimalScenario.run_all``:
record keys, and SE values equal to the JAX package's on the same operator.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import algos as jalgos
from tramp_tpu import channels as jchannels
from tramp_tpu import parallel as jparallel
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch import algos, channels, experiments, parallel
from tramp_tpu_torch.lanes import model_lanes
from tramp_tpu_torch.priors import GaussBernoulliPrior

from torch_parity import assert_close

CS = dict(prior_type="gauss_bernoulli", output_type="gaussian",
          output_var=1e-11)
ALPHAS, RHOS = [0.2, 0.5, 0.9], [0.1, 0.25, 0.5]
GRID = [(a, r) for a in ALPHAS for r in RHOS]

# tests/test_golden_csv.py: rho = linspace(0.05, 0.95, 19), a0 = 0, perfect
CS_CRITICAL_REF = [
    0.11866175048828126, 0.20752849365234377, 0.28565310302734376,
    0.3559652514648438, 0.4204180541992188, 0.48096462646484384,
    0.5366284106445314, 0.5893625219726562, 0.6391669604492187,
    0.6860417260742188, 0.7299868188476561, 0.7719787963867187,
    0.8100645434570313, 0.8461971752929689, 0.8803766918945313,
    0.9116265356445312, 0.9389701489257812, 0.9643606469726562,
    0.9858449145507813,
]


def _models(pkg):
    return [pkg.glm_state_evolution(alpha=a, prior_rho=r, **CS)
            for a, r in GRID]


def test_stack_models_gives_differing_hyperparameters_lanes():
    models = _models(tt)
    stacked = parallel.stack_models(models, device="cpu")
    prior, channel, likelihood = stacked.factors
    assert prior.rho.shape == channel.alpha.shape == (9, 1)
    assert prior.rho.dtype == torch.float64
    assert prior.rho[:, 0].tolist() == [r for _, r in GRID]
    assert channel.alpha[:, 0].tolist() == [a for a, _ in GRID]
    # equal in all models: the Python numbers they were
    assert prior.mean == 0.0 and prior.var == 1.0 and likelihood.var == 1e-11
    assert model_lanes(stacked, models[0]) == 9
    assert models[0].factors[0].rho == 0.1          # the models are untouched
    with pytest.raises(ValueError, match="structure"):
        parallel.stack_models([models[0], _relu_model(0.5, 0.2)])


def _relu_model(alpha, rho):
    from tramp_tpu_torch.likelihoods import GaussianLikelihood
    return (GaussBernoulliPrior(size=1, rho=rho) @ tt.V(id="x")
            @ channels.MarchenkoPasturChannel(alpha) @ tt.V(id="z")
            @ channels.ReluChannel() @ tt.V(id="a")
            @ GaussianLikelihood(y=None, var=1e-2)).to_model()


def test_solve_batch_matches_single_solves_and_jax():
    models, j_models = _models(tt), _models(jt)
    solver = parallel.SESolver(models[0], device="cpu")
    assert solver.engine.dtype == torch.float64
    init = algos.CustomInit(a_init=[("x", "bwd", 0.0)])
    post, n_iter = solver.solve_batch(
        parallel.stack_models(models, device="cpu"), initializer=init)
    assert n_iter.shape == (9,) and post["x"]["v"].shape == (9,)
    assert len(set(n_iter.tolist())) > 1
    for lane, model in enumerate(models):
        post_1, n_1, conv = solver.solve_info(model, initializer=init)
        assert int(n_1) == int(n_iter[lane]) and bool(conv)
        for id in ("x", "z"):
            assert post_1[id]["v"].shape == ()
            assert_close(post[id]["v"][lane], post_1[id]["v"], 1e-12)
    j_solver = jparallel.SESolver(j_models[0])
    j_post, j_n = j_solver.solve_batch(
        jparallel.stack_pytrees(j_models),
        initializer=jalgos.CustomInit(a_init=[("x", "bwd", 0.0)]))
    assert n_iter.tolist() == np.asarray(j_n).tolist()
    for id in ("x", "z"):
        assert_close(post[id]["v"], np.asarray(j_post[id]["v"]), 1e-9)


def test_solve_batch_with_an_initializer_per_lane_and_a_resumed_state():
    models, j_models = _models(tt)[:4], _models(jt)[:4]
    a0s = [0.0, 1.0, 50.0, 1e3]
    solver = parallel.SESolver(models[0], device="cpu")
    stacked = parallel.stack_models(models, device="cpu")
    post, state, n_iter = solver.solve_batch_with_state(stacked, [
        algos.CustomInit(a_init=[("x", "bwd", a0)]) for a0 in a0s])
    assert state[0]["a"].shape == (4, 1)
    for lane, (model, a0) in enumerate(zip(models, a0s)):
        post_1, n_1 = solver.solve(
            model, algos.CustomInit(a_init=[("x", "bwd", a0)]))
        assert int(n_1) == int(n_iter[lane])
        assert_close(post["x"]["v"][lane], post_1["x"]["v"], 1e-12)
    j_post, j_n = jparallel.SESolver(j_models[0]).solve_batch(
        jparallel.stack_pytrees(j_models), initializer=[
            jalgos.CustomInit(a_init=[("x", "bwd", a0)]) for a0 in a0s])
    assert n_iter.tolist() == np.asarray(j_n).tolist()
    assert_close(post["x"]["v"], np.asarray(j_post["x"]["v"]), 1e-9)
    # resumed from its fixed point, every lane stops at once
    post_2, n_2 = solver.solve_batch(stacked, state=state)
    assert int(n_2.max()) <= 2
    # (tol 1e-6 on v: the second solve moves v by less than ten times that)
    np.testing.assert_allclose(post_2["x"]["v"].numpy(),
                               post["x"]["v"].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="initializers for 4 lanes"):
        solver.solve_batch(stacked, [algos.ConstantInit()] * 3)


def test_relu_channel_batch_matches_single_solves():
    "Lanes through the piecewise-linear integrand: (B, nodes) grids."
    models = [_relu_model(a, r) for a, r in ((0.5, 0.2), (1.5, 0.3))]
    solver = parallel.SESolver(models[0], device="cpu", max_iter=12)
    post, n_iter = solver.solve_batch(
        parallel.stack_models(models, device="cpu"))
    for lane, model in enumerate(models):
        post_1, n_1 = solver.solve(model)
        assert int(n_1) == int(n_iter[lane])
        for id in ("x", "z", "a"):
            assert_close(post[id]["v"][lane], post_1[id]["v"], 1e-10)


def test_run_se_phase_grid_matches_jax():
    kw = dict(grid_kwargs={"alpha": ALPHAS, "prior_rho": RHOS},
              ids=("x", "z"), a0=0.0, **CS)
    df = parallel.run_se_phase_grid(tt.glm_state_evolution, device="cpu",
                                    **kw)
    j_df = jparallel.run_se_phase_grid(jt.glm_state_evolution, **kw)
    assert list(df.columns) == list(j_df.columns)
    assert len(df) == len(j_df) == 18
    for column in ("alpha", "prior_rho", "id", "n_iter"):
        assert df[column].tolist() == j_df[column].tolist()
    assert_close(df["v"].to_numpy(), j_df["v"].to_numpy(), 1e-9)
    records = parallel.se_phase_grid_records(
        tt.glm_state_evolution, device="cpu", **kw)
    assert records == df.to_dict("records")
    assert parallel.grid_combos({"a": [1, 2], "b": 3.0}) == \
        jparallel.grid_combos({"a": [1, 2], "b": 3.0})


def test_cs_critical_lines_golden_batched():
    alphas = experiments.find_critical_alpha_batched(
        id="x", a0=0, mse_criterion="perfect",
        alpha_min=1e-5, alpha_max=2.0, alpha_tol=0.001,
        model_builder=tt.glm_state_evolution,
        grid_kwargs={"prior_rho": list(np.linspace(0.05, 0.95, 19))},
        device="cpu", **CS)
    np.testing.assert_allclose(alphas, CS_CRITICAL_REF, atol=1e-12)


def test_critical_alpha_sequential_and_random_criterion():
    kw = dict(id="x", a0=0, alpha_min=1e-5, alpha_max=2.0, alpha_tol=0.001,
              model_builder=tt.glm_state_evolution, device="cpu", **CS)
    alpha = experiments.find_critical_alpha(
        mse_criterion="perfect", prior_rho=0.25, **kw)
    np.testing.assert_allclose(alpha, CS_CRITICAL_REF[4], atol=1e-12)
    # two equal lines: nothing differs, so there are no lanes to stack
    got = experiments.find_critical_alpha_batched(
        mse_criterion="perfect", grid_kwargs={"prior_rho": [0.25, 0.25]},
        **kw)
    np.testing.assert_allclose(got, [CS_CRITICAL_REF[4]] * 2, atol=1e-12)
    assert experiments.binary_search(lambda x: x > 0.3, 0.0, 1.0, 1e-3)[
        "xmid"] == pytest.approx(0.3, abs=1e-3)
    with pytest.raises(ValueError, match="Bad bounds"):
        experiments.find_critical_alpha_batched(
            mse_criterion="perfect", grid_kwargs={"prior_rho": [0.2, 0.3]},
            **dict(kw, alpha_max=0.1))


def _generative(pkg, W):
    if pkg is tt:
        prior = GaussBernoulliPrior(size=W.shape[1], rho=0.3, device="cpu",
                                    dtype=torch.float64)
        linear = channels.LinearChannel(W, device="cpu", dtype=torch.float64)
        noise = channels.GaussianChannel(var=1e-2)
    else:
        prior = JGaussBernoulliPrior(size=W.shape[1], rho=0.3)
        linear = jchannels.LinearChannel(jnp.asarray(W))
        noise = jchannels.GaussianChannel(var=1e-2)
    return (prior @ pkg.V(id="x") @ linear @ pkg.V(id="z") @ noise
            @ pkg.O(id="y")).to_model()


def test_bayes_optimal_scenario_records():
    W = np.random.RandomState(0).randn(60, 80) / np.sqrt(80)
    scenario = tt.BayesOptimalScenario(_generative(tt, W))
    records = scenario.run_all("EP,SE", metrics=["mse", "overlap"], seed=1,
                               max_iter=100, damping=0.1)
    assert [(r["source"], r["x_id"]) for r in records] == [
        ("SE", "x"), ("EP", "x"), ("mse", "x"), ("overlap", "x")]
    se, ep, mse, _ = records
    assert set(se) == set(ep) == {"source", "x_id", "v", "n_iter"}
    assert set(mse) == {"source", "x_id", "v"}
    assert scenario.x_true["x"].shape == (80,)
    # the SE of the student depends on the operator alone, not on the draw
    j_se = jt.StateEvolution(_generative(jt, W).to_observed(
        {"y": jnp.zeros(60)})).iterate(max_iter=100, damping=0.1)
    assert se["n_iter"] == j_se.n_iter
    assert_close(np.float64(se["v"]),
                 np.asarray(j_se.get_variable_data("x")["v"]), 1e-9)
    # EP on an instance of 80 variables lands near its SE
    assert 0.2 < ep["v"] / se["v"] < 5.0 and np.isfinite(mse["v"])
    assert experiments.run_state_evolution(
        ["x"], scenario.student, max_iter=100, damping=0.1) == [
        dict(x_id="x", v=se["v"], n_iter=se["n_iter"])]
    df = scenario.ep_convergence(["mse"], max_iter=20, damping=0.1)
    assert {"id", "iter", "mse", "v"} <= set(df.columns) and len(df) > 2
    assert len(scenario.se_convergence(max_iter=20)) > 2


def test_glm_generative_and_registries():
    g = torch.Generator().manual_seed(0)
    model = tt.glm_generative(
        N=40, alpha=0.5, ensemble_type="gaussian",
        prior_type="gauss_bernoulli", output_type="gaussian", generator=g,
        device="cpu", dtype=torch.float64, prior_rho=0.3, output_var=1e-2)
    assert model.variable_ids == ["x", "z", "y"]
    assert model.get_shapes() == {"x": (40,), "z": (20,), "y": (20,)}
    sample = model.sample(g)
    assert sample["y"].shape == (20,) and sample["y"].dtype == torch.float64
    relu = tt.glm_generative(
        N=40, alpha=0.5, ensemble_type="gaussian",
        prior_type="gauss_bernoulli", output_type="relu", generator=g,
        device="cpu")
    assert type(relu.factors[2]) is channels.ReluChannel
    # every prior and output type of the JAX registries builds (Queue 1
    # item 3), and the complex GLM (item 4a)
    for kw in (dict(prior_type="binary", output_type="gaussian"),
               dict(prior_type="gauss_bernoulli", output_type="sgn"),
               dict(prior_type="binary", output_type="door",
                    output_width=0.5),
               dict(prior_type="gauss_bernoulli", output_type="modulus")):
        se = tt.StateEvolution(tt.glm_state_evolution(alpha=0.5, **kw),
                               device="cpu").iterate(max_iter=3)
        assert 0 < float(se.get_variable_data("x")["v"]) <= 1.0
    pr = tt.glm_generative(N=40, alpha=0.5, ensemble_type="gaussian",
                           prior_type="gauss_bernoulli",
                           output_type="modulus", generator=g, device="cpu")
    assert type(pr.factors[1]) is channels.ComplexLinearChannel
    assert pr.get_shapes()["z"] == (2, 20)
    results = experiments.simple_run_experiments(
        lambda alpha, rho: dict(v=alpha * rho), alpha=[1.0, 2.0], rho=0.5)
    assert results["v"].tolist() == [0.5, 1.0]
    assert experiments.get_experiments_from_kwargs(a=[1, 2], b="c") == [
        dict(a=1, b="c"), dict(a=2, b="c")]
