"""tramp_tpu_torch.parallel.MLVAMPSolver and dispatch_solver against
tramp_tpu.parallel, float64 on the CPU.

Instances are made with numpy from a seed; the port's model is converted
from the JAX model (tests/torch_parity.py), so both sides hold the same
arrays and the same SVD. On the CPU the relu factor's messages run the
plain versions of the message kernels on the port's side and the jnp region
path on the JAX side.

Tolerances (torch_parity.assert_close: relative to each element, with a
floor of rtol times the array's largest magnitude):
- one ``_step`` from a carry that JAX reached after three steps: rtol 1e-10
  on every leaf of the carry;
- ``solve_info``: equal ``n_iter`` and ``conv``, r and v of every variable
  at rtol 1e-8 (roundoff compounded over the damped sweeps of the solve).
"""
import functools

import jax
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

from torch_parity import assert_close, port_model

F64 = torch.float64
RHO, NOISE = 0.25, 1e-2
SOLVE = dict(damping=0.1, max_iter=500, tol=1e-8)


@functools.lru_cache(maxsize=None)
def chain(kind, N=128, seed=11, observed=True):
    """(JAX model, port model): the relu net x -> W -> relu -> + noise -> y
    or the GLM x -> W -> + noise -> y, M = N / 2. Built once per case: no
    test changes them."""
    M = N // 2
    rng = np.random.RandomState(seed)
    W = rng.randn(M, N) / np.sqrt(N)
    x0 = (rng.rand(N) < RHO) * rng.randn(N)
    z = W @ x0
    dag = (JGaussBernoulliPrior(size=N, rho=RHO) @ jt.V(id="x")
           @ JLinearChannel(jnp.asarray(W), name="W") @ jt.V(id="z"))
    if kind == "relu_net":
        z = np.maximum(z, 0.0)
        dag = dag @ JReluChannel() @ jt.V(id="a")
    y = z + np.sqrt(NOISE) * rng.randn(M)
    model = (dag @ JGaussianChannel(var=NOISE) @ jt.O(id="y")).to_model()
    if observed:
        model = model.to_observed({"y": jnp.asarray(y)})
    return model, port_model(model)


def carry_to_torch(carry):
    msgs, txs = carry
    return (tuple({k: torch.as_tensor(np.array(v)) for k, v in m.items()}
                  for m in msgs),
            {k: torch.as_tensor(np.array(v)) for k, v in txs.items()})


def assert_carries_close(carry, j_carry, rtol):
    assert len(carry[0]) == len(j_carry[0])
    for i, (m, jm) in enumerate(zip(carry[0], j_carry[0])):
        assert set(m) == set(jm), i
        for k in jm:
            assert_close(m[k], jm[k], rtol, what=f"interface {i} {k}")
    assert set(carry[1]) == set(j_carry[1])
    for k, v in j_carry[1].items():
        assert_close(carry[1][k], v, rtol, what=f"tx {k}")


def assert_solves_match(solver, j_solver, p_model, j_model, rtol=1e-8):
    j_post, j_n, j_conv = j_solver.solve_info(j_model)
    post, n_iter, conv = solver.solve_info(p_model)
    assert int(n_iter) == int(j_n) and bool(conv) == bool(j_conv)
    assert set(post) == set(j_post)
    for vid in j_post:
        for key in ("r", "v"):
            assert_close(post[vid][key], j_post[vid][key], rtol,
                         what=f"{vid} {key}")
    return int(n_iter), bool(conv)


CASES = [("relu_net", True), ("relu_net", False), ("glm", True),
         ("glm", False)]
CASE_IDS = ["relu_net-pinned", "relu_net-unpinned", "glm_tail-pinned",
            "glm_tail-unpinned"]


@pytest.mark.parametrize("kind,pin", CASES, ids=CASE_IDS)
def test_init_and_step_match_jax(kind, pin):
    j_model, p_model = chain(kind)
    j_solver = jparallel.MLVAMPSolver(j_model, damping=0.1, pin_terminal=pin)
    solver = parallel.MLVAMPSolver(p_model, damping=0.1, pin_terminal=pin)
    assert solver._pin_terminal == j_solver._pin_terminal == pin
    assert solver._skip_fwd_terminal == j_solver._skip_fwd_terminal == (
        pin and kind == "glm")
    j_carry = j_solver._init(j_model)
    carry = solver._init(p_model)
    assert_carries_close(carry, j_carry, 0.0)
    for m, jm in zip(carry[0], j_carry[0]):
        for k in jm:
            assert tuple(m[k].shape) == tuple(jm[k].shape), k
    j_step = jax.jit(j_solver._step)   # compiled once: eager JAX is slower
    for _ in range(3):
        j_carry = j_step(j_model, j_carry)
    assert_carries_close(solver._step(p_model, carry_to_torch(j_carry)),
                         j_step(j_model, j_carry), 1e-10)


@pytest.mark.parametrize("kind,pin", CASES, ids=CASE_IDS)
def test_solve_matches_jax(kind, pin):
    j_model, p_model = chain(kind)
    n_iter, conv = assert_solves_match(
        parallel.MLVAMPSolver(p_model, pin_terminal=pin, **SOLVE),
        jparallel.MLVAMPSolver(j_model, pin_terminal=pin, **SOLVE),
        p_model, j_model)
    assert conv and 5 < n_iter < 500


def test_unpinned_solver_follows_the_engine():
    """With pin_terminal=False the chain solver's trajectory is the
    engine's (tests/test_ml_vamp.py:82-96): 30 sweeps, no stop rule."""
    _, p_model = chain("relu_net")
    kw = dict(damping=0.1, max_iter=30, tol=0.0)
    post_ep, n_ep = parallel.EPSolver(
        p_model, rollback_increase=float("inf"), **kw).solve(p_model)
    post_ml, n_ml = parallel.MLVAMPSolver(
        p_model, pin_terminal=False, **kw).solve(p_model)
    assert int(n_ep) == int(n_ml) == 30
    for vid in ("x", "z", "a"):
        assert_close(post_ml[vid]["r"], post_ep[vid]["r"], 1e-9, what=vid)


def test_max_iter_stops_an_unconverged_solve():
    j_model, p_model = chain("relu_net")
    kw = dict(damping=0.1, max_iter=4, tol=1e-12)
    n_iter, conv = assert_solves_match(
        parallel.MLVAMPSolver(p_model, **kw),
        jparallel.MLVAMPSolver(j_model, **kw), p_model, j_model, rtol=1e-10)
    assert n_iter == 4 and not conv


ROUTES = {"glm": ("glm", True, "SpectralVAMPSolver"),
          "relu_net": ("relu_net", True, "MLVAMPSolver"),
          "unobserved": ("relu_net", False, "EPSolver")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_dispatch_solver_routes(route):
    kind, observed, want = ROUTES[route]
    j_model, p_model = chain(kind, N=64, observed=observed)
    j_solver = jparallel.dispatch_solver(j_model, max_iter=50)
    solver = parallel.dispatch_solver(p_model, max_iter=50)
    assert type(solver).__name__ == type(j_solver).__name__ == want
    assert type(solver) is getattr(parallel, want)
    assert solver.max_iter == 50 and solver.tol == 1e-6
    if want == "EPSolver":
        # the front door's default damping of the generic engine
        assert max(solver.damp) == max(j_solver.damp) == 0.1


@pytest.mark.parametrize("route,kw", [
    ("glm", {"pin_terminal": False}), ("glm", {"rollback_increase": 1.0}),
    ("relu_net", {"stop_kind": "v"}), ("unobserved", {"pin_terminal": True}),
], ids=["spectral-pin_terminal", "spectral-rollback", "mlvamp-stop_kind",
        "ep-pin_terminal"])
def test_dispatch_solver_rejects_unknown_keyword(route, kw):
    kind, observed, _ = ROUTES[route]
    j_model, p_model = chain(kind, N=64, observed=observed)
    with pytest.raises(TypeError):
        jparallel.dispatch_solver(j_model, **kw)
    with pytest.raises(TypeError):
        parallel.dispatch_solver(p_model, **kw)


def test_dispatched_solvers_reach_the_engines_fixed_point():
    "All three front-door routes of one problem family agree (rtol 1e-5)."
    _, p_model = chain("glm", N=128)
    tight = dict(max_iter=800, tol=1e-11)
    post_v, _, conv_v = parallel.dispatch_solver(
        p_model, **tight).solve_info(p_model)
    post_ml, _, conv_ml = parallel.MLVAMPSolver(
        p_model, damping=0.1, **tight).solve_info(p_model)
    post_ep, _, conv_ep = parallel.EPSolver(
        p_model, damping=0.1, **tight).solve_info(p_model)
    assert bool(conv_v) and bool(conv_ml) and bool(conv_ep)
    for vid in ("x", "z"):
        assert_close(post_ml[vid]["r"], post_ep[vid]["r"], 1e-6, what=vid)
        assert_close(post_v[vid]["r"], post_ep[vid]["r"], 1e-5, what=vid)


def test_rejects_a_model_that_is_no_chain():
    j_model, p_model = chain("relu_net", N=64, observed=False)
    with pytest.raises(ValueError, match="SISO factor chain"):
        jparallel.MLVAMPSolver(j_model)
    with pytest.raises(ValueError, match="SISO factor chain"):
        parallel.MLVAMPSolver(p_model)
