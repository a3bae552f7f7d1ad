"""A variable of shape (N, K) through the port's ``LinearChannel``,
tramp_tpu_torch against tramp_tpu, float64 on the CPU.

The JAX package multiplies an (N, K) variable as ``W @ Z``, broadcasting
the singular values over the trailing K axis
(tramp_tpu/channels/linear_channel.py:115-121, 145). The port tells lanes
from the precision (``lanes.lane_count``), so that ``(n, K)`` and ``(B,
n)`` no longer look alike: the four layouts ``(n,)``, ``(n, K)``, ``(B,
n)`` and ``(B, n, K)`` each hold against the JAX call (on each lane).

The GLMs ``MAP_L21NormPrior(size=(N, K), axis=1)`` and
``GaussianPrior(size=(N, K))`` through ``LinearChannel(W)`` into a Gaussian
likelihood then run through the engine and ``EPSolver``, one instance and
3 lanes (an observation each), against the JAX package. The JAX engine's
spectral carry keeps a placeholder image of shape (k,), which does not
broadcast against an (N, K) variable's (k, K) image, so the JAX side runs
with ``config.SPECTRAL_CARRY = False``; its uncached sweeps are the ones
the port's carried image reproduces (tests/test_spectral_carry.py).
Tolerance: rtol 1e-10 for one call, 1e-8 after a solve
(torch_parity.assert_close).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import config as jconfig
from tramp_tpu.algos import ConstantInit as JConstantInit
from tramp_tpu.channels import LinearChannel as JLinear
from tramp_tpu.likelihoods import GaussianLikelihood as JGaussianLikelihood
from tramp_tpu.parallel import EPSolver as JEPSolver
from tramp_tpu.priors import (
    GaussianPrior as JGaussianPrior, MAP_L21NormPrior as JL21)

import tramp_tpu_torch as tt
from tramp_tpu_torch.lanes import with_buffers
from tramp_tpu_torch.parallel import EPSolver

from torch_parity import assert_close, describe_factor, port_model
from tramp_tpu_torch import convert

F64 = torch.float64
N, M, K = 24, 18, 2


@pytest.fixture
def no_jax_carry(monkeypatch):
    monkeypatch.setattr(jconfig, "SPECTRAL_CARRY", False)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _pair(shape):
    rng = np.random.RandomState(sum(shape))
    jch = JLinear(rng.randn(*shape) / np.sqrt(shape[1]))
    return jch, convert.factor_from_description(describe_factor(jch),
                                                device="cpu", dtype=F64)


SHAPES = {"tall": (M + 12, N), "wide": (M, N)}


@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_linear_channel_nk_messages(shape, lanes):
    """Posteriors, messages and the log-partition of an (N, K) variable,
    one instance or 3 lanes ``(3, n, K)`` with precisions ``(3, 1, 1)``."""
    jch, ch = _pair(SHAPES[shape])
    Nx, Nz = SHAPES[shape]
    rng = np.random.RandomState(7)
    lead = () if lanes is None else (lanes,)
    a_shape = () if lanes is None else (lanes, 1, 1)
    az, ax = rng.uniform(0.5, 3.0, a_shape), rng.uniform(0.5, 3.0, a_shape)
    bz, bx = rng.randn(*lead, Nz, K), rng.randn(*lead, Nx, K)
    for method in ("compute_forward_posterior", "compute_backward_posterior",
                   "compute_forward_message", "compute_backward_message",
                   "compute_log_partition"):
        got = getattr(ch, method)(_t(az), _t(bz), _t(ax), _t(bx))
        for i in range(1 if lanes is None else lanes):
            sel = (lambda x: x) if lanes is None else (lambda x: x[i])
            want = getattr(jch, method)(
                float(az.reshape(-1)[i]), jnp.asarray(sel(bz)),
                float(ax.reshape(-1)[i]), jnp.asarray(sel(bx)))
            if method == "compute_log_partition":
                got_i = got if lanes is None else got[i]
                assert_close(got_i, want, 1e-10, what=f"{method} lane {i}")
                continue
            for g, w in zip(got, want):
                g = g if lanes is None or g.numel() == 1 else g[i]
                assert_close(g.reshape(np.shape(w)), w, 1e-10,
                             what=f"{shape} {method} lane {i}")


def test_linear_channel_vector_lanes_unchanged():
    """``(B, n)`` with ``(B, 1)`` precisions still reads as lanes, and a
    trailing K axis of length B is not mistaken for them."""
    jch, ch = _pair(SHAPES["wide"])
    rng = np.random.RandomState(8)
    az, ax = rng.uniform(0.5, 3.0, (N, 1)), rng.uniform(0.5, 3.0, (N, 1))
    bz, bx = rng.randn(N, N), rng.randn(N, M)
    rz, vz = ch.compute_backward_posterior(_t(az), _t(bz), _t(ax), _t(bx))
    for i in (0, N - 1):
        want = jch.compute_backward_posterior(az[i, 0], jnp.asarray(bz[i]),
                                              ax[i, 0], jnp.asarray(bx[i]))
        assert_close(rz[i], want[0], 1e-10)
        assert_close(vz[i, 0], want[1], 1e-10)
    # the same numbers as one (N, K = N) variable with one precision
    rz, _ = ch.compute_backward_posterior(_t(az[0, 0]), _t(bz.T),
                                          _t(ax[0, 0]), _t(bx.T))
    assert_close(rz, jch.compute_backward_posterior(
        az[0, 0], jnp.asarray(bz.T), ax[0, 0], jnp.asarray(bx.T))[0], 1e-10)


def _instance(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(M, N) / np.sqrt(N), rng.randn(M, K)


def _glm(prior, W, y):
    return (prior @ jt.V(id="x") @ JLinear(W) @ jt.V(id="z")
            @ JGaussianLikelihood(y=y, var=0.1)).to_model()


PRIORS = {
    "l21": (lambda: JL21(size=(N, K), axis=1), (1.0, 1.0)),
    "gaussian": (lambda: JGaussianPrior(size=(N, K)), (0.0, 0.0)),
}


@pytest.mark.parametrize("kind", list(PRIORS))
def test_nk_glm_engine(kind, no_jax_carry):
    """20 sweeps of the engine: every slot against the JAX engine's (the
    L21 case from ConstantInit(a=1, b=1), as chip_smoke.py phase 12)."""
    build, (a0, b0) = PRIORS[kind]
    jmodel = _glm(build(), *_instance(1))
    jep = jt.ExpectationPropagation(jmodel)
    jep.iterate(max_iter=20, damping=0.1, tol=0.0,
                initializer=JConstantInit(a=a0, b=b0))
    ep = tt.ExpectationPropagation(port_model(jmodel))
    ep.iterate(max_iter=20, damping=0.1, tol=0.0,
               initializer=tt.ConstantInit(a=a0, b=b0))
    assert ep.n_iter == jep.n_iter == 20
    for s in range(ep.n_slots):
        for k in ("a", "b"):
            assert_close(ep.state[s][k], jep.state[s][k], 1e-8,
                         what=f"{kind} slot {s} {k}")
    # the carried image is U^T bx of the final backward message
    (i,) = ep.spectral_factors
    msg = ep.state[2 * ep.model.out_edges[i][0] + 1]
    assert_close(ep.state[ep.n_slots][str(i)],
                 ep.nodes[i].U.T @ msg["b"], 1e-12)


@pytest.mark.parametrize("kind", list(PRIORS))
def test_nk_glm_solver_and_lanes(kind, no_jax_carry):
    """``EPSolver.solve`` against the JAX solver, then 3 lanes on one W,
    an observation each, each lane against the JAX solve of its model."""
    build, (a0, b0) = PRIORS[kind]
    kw = dict(damping=0.1, max_iter=60, tol=1e-6)
    W, y = _instance(2)
    jmodel = _glm(build(), W, y)
    model = port_model(jmodel)
    post, n_iter = EPSolver(model, **kw).solve(
        model, initializer=tt.ConstantInit(a=a0, b=b0))
    jpost, jn = JEPSolver(jmodel, **kw).solve(
        jmodel, initializer=JConstantInit(a=a0, b=b0))
    assert int(n_iter) == int(jn)
    for key in ("r", "v"):
        assert_close(post["x"][key], jpost["x"][key], 1e-8, what=key)
    rng = np.random.RandomState(3)
    ys = rng.randn(3, M, K)
    index = next(i for i, f in enumerate(model.factors)
                 if type(f).__name__ == "GaussianLikelihood")
    batch = with_buffers(model, {(index, "y"): _t(ys)})
    bpost, bn = EPSolver(model, **kw).solve_batch(
        batch, initializer=tt.ConstantInit(a=a0, b=b0))
    assert bpost["x"]["r"].shape == (3, N, K)
    for i in range(3):
        jm = _glm(build(), W, ys[i])
        jp, jn = JEPSolver(jm, **kw).solve(
            jm, initializer=JConstantInit(a=a0, b=b0))
        assert int(bn[i]) == int(jn)
        assert_close(bpost["x"]["r"][i], jp["x"]["r"], 1e-8, what=f"lane {i}")
        assert_close(bpost["x"]["v"][i], jp["x"]["v"], 1e-8, what=f"lane {i}")
