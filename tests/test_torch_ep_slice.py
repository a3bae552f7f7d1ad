"""The EP slice of tramp_tpu_torch against tramp_tpu: the relu net
(x -> W -> relu -> + noise -> y) at N = 256, M = 128 and the flagship
compressed-sensing GLM at N = 200, M = 100, in float64 on the CPU.

Tolerances (torch_parity.assert_close: relative to each element, with a
floor of rtol times the array's largest magnitude):
- DSL structure (node classes and ids, edges): exact.
- Harmonized init state: exact (same shapes, dtypes and values).
- One sweep from one converted engine state: rtol 1e-11. The arithmetic is
  the same; only elementwise roundoff and matmul summation order differ.
- A full ``iterate(damping=0.1, tol=1e-6)``: the same ``n_iter``, and the
  x posterior's r and v at rtol 1e-8 (that roundoff, compounded over the
  damped sweeps of the solve).
"""
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu.channels import (
    GaussianChannel as JGaussianChannel, LinearChannel as JLinearChannel,
    ReluChannel as JReluChannel,
)
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import tramp_tpu_torch as pt
from tramp_tpu_torch import convert
from tramp_tpu_torch.channels import GaussianChannel, LinearChannel, ReluChannel
from tramp_tpu_torch.priors import GaussBernoulliPrior

from torch_parity import (
    assert_close, assert_states_close, describe_model, describe_state,
)

F64 = torch.float64
RHO, NOISE = 0.25, 1e-2
SLICES = ("relu_net", "flagship")


def _data(kind):
    "Instance data made with numpy from a seed, as bench.py:1134-1138 does."
    N = 256 if kind == "relu_net" else 200
    M = N // 2
    rng = np.random.RandomState(11)
    W = rng.randn(M, N) / np.sqrt(N)
    x0 = (rng.rand(N) < RHO) * rng.randn(N)
    z = W @ x0
    if kind == "relu_net":
        z = np.maximum(z, 0.0)
    y = z + np.sqrt(NOISE) * rng.randn(M)
    return W, x0, y


def _jax_student(kind, W, y):
    import jax.numpy as jnp
    N = W.shape[1]
    dag = (JGaussBernoulliPrior(size=N, rho=RHO) @ jt.V(id="x")
           @ JLinearChannel(jnp.asarray(W), name="W") @ jt.V(id="z"))
    if kind == "relu_net":
        dag = dag @ JReluChannel() @ jt.V(id="a")
    dag = dag @ JGaussianChannel(var=NOISE) @ jt.O(id="y")
    return dag.to_model().to_observed({"y": jnp.asarray(y)})


def _port_student(kind, W, y):
    N = W.shape[1]
    dag = (GaussBernoulliPrior(size=N, rho=RHO, device="cpu", dtype=F64)
           @ pt.V(id="x") @ LinearChannel(W, name="W", device="cpu", dtype=F64)
           @ pt.V(id="z"))
    if kind == "relu_net":
        dag = dag @ ReluChannel() @ pt.V(id="a")
    dag = dag @ GaussianChannel(var=NOISE) @ pt.O(id="y")
    return dag.to_model().to_observed({"y": torch.as_tensor(y, dtype=F64)})


def _structure(model):
    nodes = [(type(n).__name__, getattr(n, "id", None)) for n in model.nodes]
    return nodes, [tuple(e) for e in model.edges]


def _pair(kind):
    "(JAX engine, port engine on the converted JAX model)."
    W, x0, y = _data(kind)
    j_student = _jax_student(kind, W, y)
    p_student = convert.model_from_description(
        describe_model(j_student), device="cpu", dtype=F64)
    return jt.ExpectationPropagation(j_student), pt.ExpectationPropagation(
        p_student), x0


@pytest.mark.parametrize("kind", SLICES)
def test_dsl_builds_the_same_graph(kind):
    W, _, y = _data(kind)
    assert _structure(_port_student(kind, W, y)) == _structure(
        _jax_student(kind, W, y))


@pytest.mark.parametrize("kind", SLICES)
def test_converted_model_matches(kind):
    j_ep, p_ep, _ = _pair(kind)
    assert _structure(p_ep.model) == _structure(j_ep.model)
    assert p_ep.spectral_factors == tuple(j_ep.spectral_factors)
    for jf, pf in zip(j_ep.model.factors, p_ep.model.factors):
        for f in type(jf)._data_fields:
            jv = getattr(jf, f)
            if jv is None or np.ndim(jv) == 0:
                assert getattr(pf, f) == jv
            else:
                assert_close(getattr(pf, f), jv, 0.0, what=f"{jf.id}.{f}")


@pytest.mark.parametrize("kind", SLICES)
def test_init_state_matches(kind):
    j_ep, p_ep, _ = _pair(kind)
    j_state, p_state = j_ep.init_state(), p_ep.init_state()
    assert len(p_state) == len(j_state)
    for pm, jm in zip(p_state, j_state):
        for k, jv in jm.items():
            assert tuple(pm[k].shape) == tuple(np.shape(jv))
            assert pm[k].dtype == F64
    assert_states_close(p_state, j_state, j_ep.n_slots, 0.0, what="init")


@pytest.mark.parametrize("kind", SLICES)
def test_one_sweep_matches(kind):
    j_ep, p_ep, _ = _pair(kind)
    damp = j_ep._damping_per_slot(0.1)
    state = j_ep.init_state()
    for _ in range(3):  # a state away from the init's symmetries
        state = j_ep._sweep(j_ep.model, state, damp)
    p_state = convert.state_from_numpy(
        *describe_state(state, j_ep.n_slots), device="cpu", dtype=F64)
    j_next = j_ep._sweep(j_ep.model, state, damp)
    p_next = p_ep._sweep(p_ep.model, p_state, p_ep._damping_per_slot(0.1))
    assert_states_close(p_next, j_next, j_ep.n_slots, 1e-11, what="sweep")


@pytest.mark.parametrize("kind", SLICES)
def test_iterate_matches(kind):
    j_ep, p_ep, x0 = _pair(kind)
    j_ep.iterate(max_iter=500, damping=0.1, tol=1e-6)
    p_ep.iterate(max_iter=500, damping=0.1, tol=1e-6)
    assert p_ep.n_iter == j_ep.n_iter
    j_x, p_x = j_ep.get_variable_data("x"), p_ep.get_variable_data("x")
    assert_close(p_x["r"], j_x["r"], 1e-8, what="r")
    assert_close(p_x["v"], j_x["v"], 1e-8, what="v")
    assert np.mean((p_x["r"].numpy() - x0) ** 2) < 1.0


ITERATE_OPTIONS = {
    "early_stop_v": lambda pkg: dict(
        early_stop=pkg.EarlyStopping(tol=1e-7), damping=0.1),
    "early_stop_r": lambda pkg: dict(
        early_stop=pkg.EarlyStoppingEP(tol=1e-5, max_increase=0.05),
        damping=0.1),
    "damping_list": lambda pkg: dict(
        damping=[("x", "fwd", 0.3), ("z", "bwd", 0.2)], tol=1e-7),
}


@pytest.mark.parametrize("option", list(ITERATE_OPTIONS))
def test_iterate_options_match(option):
    "Stop rules and per-variable damping: n_iter equal, r and v at 1e-8."
    j_ep, p_ep, _ = _pair("flagship")
    j_ep.iterate(max_iter=300, **ITERATE_OPTIONS[option](jt))
    p_ep.iterate(max_iter=300, **ITERATE_OPTIONS[option](pt))
    assert p_ep.n_iter == j_ep.n_iter
    j_x, p_x = j_ep.get_variable_data("x"), p_ep.get_variable_data("x")
    assert_close(p_x["r"], j_x["r"], 1e-8, what="r")
    assert_close(p_x["v"], j_x["v"], 1e-8, what="v")


def test_finite_guard_matches():
    "A sweep that goes non-finite is dropped and stops the loop."
    j_ep, p_ep, _ = _pair("flagship")
    import jax.numpy as jnp
    j_ep.state = j_ep.init_state()
    j_ep.state[1]["b"] = jnp.full_like(j_ep.state[1]["b"], jnp.nan)
    p_ep.state = convert.state_from_numpy(
        *describe_state(j_ep.state, j_ep.n_slots), device="cpu", dtype=F64)
    j_ep.iterate(max_iter=50, damping=0.1, warm_start=True)
    p_ep.iterate(max_iter=50, damping=0.1, warm_start=True)
    assert p_ep.n_iter == j_ep.n_iter == 1
    assert bool(torch.isnan(p_ep.state[1]["b"]).all())
    for s in range(2, j_ep.n_slots):
        for k in ("a", "b"):
            assert_close(p_ep.state[s][k], j_ep.state[s][k], 0.0)
