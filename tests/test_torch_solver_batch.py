"""Batched solves of tramp_tpu_torch.parallel (EPSolver, SpectralVAMPSolver,
MLVAMPSolver) against their single solves and against tramp_tpu's
``solve_batch``, float64 on the CPU, four lanes that stop at different
iterations.

Both layouts of a batch: whole models stacked (an operator, its SVD and an
observation per lane, ``stack_models``, as tests/test_vamp_glm.py:79-88
stacks them) and one model with only the observation stacked
(``with_buffers``, one operator for all lanes, as bench.py:211-224 does).

Tolerances (torch_parity.assert_close: relative to each element, with a
floor of rtol times the array's largest magnitude): a lane of a batched
solve against the single solve on that lane's model, and against the same
lane of the JAX package's batched solve: equal ``n_iter``, r and v at rtol
1e-8 (tests/test_vamp_glm.py:79-88, tests/test_parallel.py:26). A batched
product sums in another order than a matvec, hence no bit-identity.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import parallel as jparallel
from tramp_tpu.channels import (
    GaussianChannel as JGaussianChannel, LinearChannel as JLinearChannel,
    ReluChannel as JReluChannel,
)
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

from tramp_tpu_torch import parallel
from tramp_tpu_torch.lanes import model_lanes

from torch_parity import assert_close, port_model

NOISE = 1e-2
LANES = 4
# sparsity of the signal by model kind, chosen so that every lane converges
RHO = {"glm": 0.15, "relu_net": 0.2}
# solver -> (model kind, constructor keywords)
SOLVERS = {
    "EPSolver": ("glm", dict(damping=0.1, max_iter=300, tol=1e-8)),
    "SpectralVAMPSolver": ("glm", dict(max_iter=300, tol=1e-10)),
    "MLVAMPSolver": ("relu_net", dict(damping=0.1, max_iter=300, tol=1e-8)),
}
LAYOUTS = ("stacked_models", "shared_operator")


def student(kind, W, y):
    N = W.shape[1]
    dag = (JGaussBernoulliPrior(size=N, rho=RHO[kind]) @ jt.V(id="x")
           @ JLinearChannel(jnp.asarray(W), name="W") @ jt.V(id="z"))
    if kind == "relu_net":
        dag = dag @ JReluChannel() @ jt.V(id="a")
    dag = dag @ JGaussianChannel(var=NOISE) @ jt.O(id="y")
    return dag.to_model().to_observed({"y": jnp.asarray(y)})


def instances(kind, layout, N=96, M=72):
    """LANES JAX students: each with its own operator, or all with the
    operator of seed 0 and observations of their own."""
    out = []
    for lane in range(LANES):
        rng = np.random.RandomState(
            0 if layout == "shared_operator" else lane)
        W = rng.randn(M, N) / np.sqrt(N)
        rng = np.random.RandomState(100 + lane)
        x0 = (rng.rand(N) < RHO[kind]) * rng.randn(N)
        z = W @ x0
        if kind == "relu_net":
            z = np.maximum(z, 0.0)
        out.append(student(kind, W, z + np.sqrt(NOISE) * rng.randn(M)))
    return out


def batched(models, layout):
    "The port's model with lanes, in the given layout."
    if layout == "stacked_models":
        return parallel.stack_models(models)
    likelihood = len(models[0].factors) - 1
    ys = torch.stack([m.factors[likelihood].y for m in models])
    return parallel.with_buffers(models[0], {(likelihood, "y"): ys})


@functools.lru_cache(maxsize=None)
def solved(name, layout):
    """(solver, single models, model with lanes, JAX models, JAX solver),
    built once per case: no test changes them."""
    kind, kw = SOLVERS[name]
    j_models = instances(kind, layout)
    models = [port_model(m) for m in j_models]
    solver = getattr(parallel, name)(models[0], **kw)
    j_solver = getattr(jparallel, name)(j_models[0], **kw)
    return solver, models, batched(models, layout), j_models, j_solver


def assert_lane_matches(post_b, n_b, lane, post, n_iter, rtol=1e-8):
    assert int(n_b[lane]) == int(n_iter)
    for vid in post:
        assert_close(post_b[vid]["r"][lane], post[vid]["r"], rtol,
                     what=f"lane {lane} {vid} r")
        assert_close(post_b[vid]["v"][lane], post[vid]["v"], rtol,
                     what=f"lane {lane} {vid} v")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", list(SOLVERS))
def test_batched_lanes_match_single_solves(name, layout):
    solver, models, stacked, _, _ = solved(name, layout)
    assert model_lanes(stacked, models[0]) == LANES
    post_b, n_b = solver.solve_batch(stacked)
    assert n_b.shape == (LANES,)
    assert len(set(n_b.tolist())) > 1, "the lanes should stop at different "\
        f"iterations: {n_b.tolist()}"
    assert int(n_b.max()) < solver.max_iter
    for vid, data in post_b.items():
        assert data["r"].shape[0] == LANES and data["v"].shape == (LANES,)
    for lane, model in enumerate(models):
        post, n_iter = solver.solve(model)
        assert_lane_matches(post_b, n_b, lane, post, n_iter)


@pytest.mark.parametrize("name", list(SOLVERS))
def test_batched_solve_matches_jax_solve_batch(name):
    solver, _, stacked, j_models, j_solver = solved(name, "stacked_models")
    j_post, j_n = j_solver.solve_batch(jparallel.stack_pytrees(j_models))
    post_b, n_b = solver.solve_batch(stacked)
    assert n_b.tolist() == np.asarray(j_n).tolist()
    assert set(post_b) == set(j_post)
    for vid in j_post:
        for key in ("r", "v"):
            want = np.asarray(j_post[vid][key])
            if key == "v":
                # an isotropic v is one value per lane on both sides
                want = want.reshape(LANES, -1)[:, 0]
            assert_close(post_b[vid][key], want, 1e-8, what=f"{vid} {key}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", list(SOLVERS))
def test_a_non_finite_lane_ends_alone(name, layout):
    """A lane whose observation holds a NaN stops at its first iteration,
    keeps its initial state and is not converged; the others go on to the
    results of their single solves."""
    solver, models, stacked, _, _ = solved(name, layout)
    likelihood = len(models[0].factors) - 1
    ys = stacked.factors[likelihood].y.clone()
    ys[2, 5] = float("nan")
    broken = parallel.with_buffers(stacked, {(likelihood, "y"): ys})
    if name == "EPSolver":
        post_b, state, n_b = solver.solve_batch_with_state(broken)
        assert all(bool(torch.isfinite(m[k][2]).all())
                   for m in state[:solver.engine.n_slots] for k in m)
    else:
        post_b, n_b = solver.solve_batch(broken)
    assert int(n_b[2]) == 1
    for lane in (0, 1, 3):
        post, n_iter = solver.solve(models[lane])
        assert_lane_matches(post_b, n_b, lane, post, n_iter)


@pytest.mark.parametrize("name", list(SOLVERS))
def test_converged_flags_are_per_lane(name):
    "conv is False for the lane that broke and True for the others."
    solver, models, stacked, _, _ = solved(name, "stacked_models")
    likelihood = len(models[0].factors) - 1
    ys = stacked.factors[likelihood].y.clone()
    ys[1, 0] = float("inf")
    broken = parallel.with_buffers(stacked, {(likelihood, "y"): ys})
    if name == "EPSolver":
        _, _, _, conv = solver._run(
            broken, solver._with_lanes(solver.init_state(), LANES))
    else:
        conv = solver._run(broken)[3]
    assert conv.tolist() == [True, False, True, True]


def test_ep_solver_resumes_from_a_batched_state():
    "Two halves of a batched solve, warm-started, end where one solve ends."
    solver, models, stacked, _, _ = solved("EPSolver", "stacked_models")
    post, n_iter = solver.solve_batch(stacked)
    kind, kw = SOLVERS["EPSolver"]
    short = parallel.EPSolver(models[0], **dict(kw, max_iter=10))
    _, state, n_first = short.solve_batch_with_state(stacked)
    assert n_first.tolist() == [10] * LANES
    post_2, n_second = solver.solve_batch(stacked, state=state)
    for vid in post:
        assert_close(post_2[vid]["r"], post[vid]["r"], 1e-6, what=vid)


@pytest.mark.parametrize("stop_kind", ["r", "v"])
def test_ep_solver_stop_kind_and_rollback_match_jax(stop_kind):
    """The stop_kind override and the rollback bounds, single and batched:
    equal n_iter and conv, r at rtol 1e-8."""
    kind, kw = SOLVERS["EPSolver"]
    kw = dict(kw, stop_kind=stop_kind, wait_increase=3,
              rollback_increase=0.5)
    j_models = instances(kind, "stacked_models")
    models = [port_model(m) for m in j_models]
    solver = parallel.EPSolver(models[0], **kw)
    j_solver = jparallel.EPSolver(j_models[0], **kw)
    assert solver.stop_kind == j_solver.stop_kind == stop_kind
    j_post, j_n, j_conv = j_solver.solve_info(j_models[1])
    post, n_iter, conv = solver.solve_info(models[1])
    assert int(n_iter) == int(j_n) and bool(conv) == bool(j_conv)
    assert_close(post["x"]["r"], j_post["x"]["r"], 1e-8)
    j_post, j_n = j_solver.solve_batch(jparallel.stack_pytrees(j_models))
    post_b, n_b = solver.solve_batch(parallel.stack_models(models))
    assert n_b.tolist() == np.asarray(j_n).tolist()
    assert_close(post_b["x"]["r"], j_post["x"]["r"], 1e-8)


def test_solve_batch_needs_lanes_and_equal_hyperparameters():
    solver, models, _, _, _ = solved("SpectralVAMPSolver", "stacked_models")
    with pytest.raises(ValueError, match="lanes"):
        solver.solve_batch(models[0])
    # a numeric hyperparameter that differs becomes one value per lane, an
    # equal one stays the number it was; a structural field must be equal
    other = port_model(student("glm", np.eye(72, 96), np.zeros(72)))
    other.factors[2].var = 0.5
    stacked = parallel.stack_models([models[0], other])
    assert stacked.factors[2].var.tolist() == [[NOISE], [0.5]]
    assert stacked.factors[0].rho == RHO["glm"]
    assert model_lanes(stacked, models[0]) == 2
    other.factors[0].isotropic = False
    with pytest.raises(ValueError, match="isotropic differs"):
        parallel.stack_models([models[0], other])
