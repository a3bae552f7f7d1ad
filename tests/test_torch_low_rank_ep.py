"""The low-rank channels inside the EP engine, tramp_tpu_torch against
tramp_tpu on the CPU in float64 (tests/test_low_rank_activation.py:326-388's
protocols).

- Sweep by sweep: the first 3 sweeps of each engine, each port sweep from
  the JAX engine's state before it (exported and converted), every slot at
  rtol 1e-8. The embedded solve is cut to t + 1 iterations of its loop
  (``max_iter = t, min_iter = t + 1, tol = 0``) in both packages: at the
  protocols' Delta its loop amplifies a rounding difference about 30-fold
  per iteration (1e-16 grows to 1e-6 in 6 iterations, to O(1) in 20), so a
  full solve is held at the solver level only (tests/test_torch_low_rank.py)
  and the engine path by its task bound.
- The task bound: the posterior mean of x under 0.25 of the signal power,
  at the JAX test's own instance for the factorization; the Gram channel's
  count over seeds is in tests/test_torch_low_rank_gram_ep.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu.channels import LowRankFactorization as JFactorization
from tramp_tpu.channels import LowRankGramChannel as JGram
from tramp_tpu.channels.low_rank import low_rank_channels as j_channels
from tramp_tpu.likelihoods import GaussianLikelihood as JGaussianLikelihood
from tramp_tpu.priors import GaussianPrior as JGaussianPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch import convert
from tramp_tpu_torch.channels import LowRankFactorization
from tramp_tpu_torch.channels.low_rank import low_rank_channels as p_channels
from tramp_tpu_torch.likelihoods import GaussianLikelihood
from tramp_tpu_torch.priors import GaussianPrior

from torch_parity import assert_states_close, describe_state, port_model

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
M, N, K, DELTA = 40, 60, 2, 0.1
GRAM_N, GRAM_DELTA = 50, 0.05


def _model(seed=0):
    rng = np.random.RandomState(seed)
    u0, v0 = rng.randn(M, K), rng.randn(N, K)
    X0 = u0 @ v0.T / np.sqrt(N)
    Y = X0 + np.sqrt(DELTA) * rng.randn(M, N)
    factor = LowRankFactorization(M=M, N=N, K=K)
    model = (
        (GaussianPrior(size=(M, K), **CPU) @ tt.V(id="u") +
         GaussianPrior(size=(N, K), **CPU) @ tt.V(id="v")) @
        factor @ tt.V(id="x") @
        GaussianLikelihood(y=Y, var=DELTA, **CPU)).to_model()
    return model, factor, X0, Y


def _jax_model(kind, seed=0):
    "The JAX package's model of the protocol: 'uv' or 'gram'."
    if kind == "uv":
        Y = _model(seed)[3]
        return (
            (JGaussianPrior(size=(M, K)) @ jt.V(id="u") +
             JGaussianPrior(size=(N, K)) @ jt.V(id="v")) @
            JFactorization(M=M, N=N, K=K) @ jt.V(id="x") @
            JGaussianLikelihood(y=jnp.asarray(Y), var=DELTA)).to_model()
    rng = np.random.RandomState(seed)
    z0 = rng.randn(GRAM_N, K)
    E = rng.randn(GRAM_N, GRAM_N)
    Y = (z0 @ z0.T / np.sqrt(GRAM_N)
         + np.sqrt(GRAM_DELTA) * (E + E.T) / np.sqrt(2))
    return (JGaussianPrior(size=(GRAM_N, K)) @ jt.V(id="z")
            @ JGram(N=GRAM_N, K=K) @ jt.V(id="x")
            @ JGaussianLikelihood(y=jnp.asarray(Y), var=GRAM_DELTA)
            ).to_model()


@pytest.mark.parametrize("t", [0, 2])
@pytest.mark.parametrize("kind", ["gram", "uv"])
def test_engine_sweeps_against_jax(kind, t, monkeypatch):
    cut = dict(max_iter=t, min_iter=t + 1, tol=0.0)
    for module in (j_channels, p_channels):
        monkeypatch.setattr(module, "vamp_matrix_factorization",
                            functools.partial(
                                module.vamp_matrix_factorization, **cut))
    j_model = _jax_model(kind)
    j_eng = jt.ExpectationPropagation(j_model)
    eng = tt.ExpectationPropagation(port_model(j_model))
    damp = j_eng._damping_per_slot(0.3)
    state = j_eng.init_state(None)
    for sweep in range(3):
        p_state = convert.state_from_numpy(
            *describe_state(state, j_eng.n_slots), **CPU)
        state = j_eng._sweep(j_eng.model, state, damp)
        p_next = eng._sweep(eng.model, p_state, eng._damping_per_slot(0.3))
        assert_states_close(p_next, state, j_eng.n_slots, 1e-8,
                            what=f"{kind} t={t} sweep {sweep}")
    # each sweep ran the forward and the backward solve, t + 1 iterations
    factor = next(f for f in eng.model.factors if hasattr(f, "stats"))
    assert factor.stats == {"solves": 6, "iterations": 6 * (t + 1)}


def test_low_rank_end_to_end_ep():
    model, factor, X0, _ = _model()
    ep = tt.ExpectationPropagation(model).iterate(max_iter=20, damping=0.3)
    assert ep.n_iter >= 3, "NaN guard must not trip on the first sweeps"
    Xh = ep.get_variable_data("x")["r"].numpy()
    assert np.all(np.isfinite(Xh))
    mse_x = float(np.mean((Xh - X0) ** 2))
    assert mse_x < 0.25 * float(np.mean(X0**2)), mse_x
    # the forward and the backward posterior solve once each per sweep
    assert factor.stats["solves"] == 2 * ep.n_iter
    assert factor.stats["iterations"] >= 26 * factor.stats["solves"]
