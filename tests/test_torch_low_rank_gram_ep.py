"""The Gram channel x = z z^T / sqrt(N) inside the EP engine,
tramp_tpu_torch against tramp_tpu on the CPU in float64, at
tests/test_low_rank_activation.py:361-388's protocol (N = 50, K = 2,
Delta = 0.05, damping 0.3, at most 20 sweeps), on seeds 0-19 at once: one
batched solve of 20 lanes (a y each) in each package.

Engine-level parity is chaotic (commit 8a2abd8): the zero-mean prior sends
the embedded XX solve a z message of 0 in every sweep, so it starts on the
saddle where the K columns of z are equal, and rounding decides how it
leaves it. Some end points are the collapsed fixed point (the posterior
mean of x near 0, MSE at the signal power), in the JAX package as in the
port, at different seeds. One seed proves nothing either way, so the task
bound (MSE under 0.25 of the signal power) is held as a count over the 20
seeds, the port's against the JAX package's on the same instances: at most
1 fewer, a bound that half the JAX package's rate, or half the port's, would
fail. Every port lane must also be finite and give a symmetric x. The first
sweeps are held against JAX step by step in
tests/test_torch_low_rank_ep.py.
"""
import jax.numpy as jnp
import numpy as np
import torch

import tramp_tpu as jt
from tramp_tpu.channels import LowRankGramChannel as JGram
from tramp_tpu.likelihoods import GaussianLikelihood as JGaussianLikelihood
from tramp_tpu.parallel.solver import EPSolver as JEPSolver, stack_pytrees
from tramp_tpu.priors import GaussianPrior as JGaussianPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch.channels import LowRankGramChannel
from tramp_tpu_torch.lanes import with_buffers
from tramp_tpu_torch.likelihoods import GaussianLikelihood
from tramp_tpu_torch.parallel import EPSolver
from tramp_tpu_torch.priors import GaussianPrior

import torch_parity  # noqa: F401  (one torch thread per test process)

CPU = dict(device="cpu", dtype=torch.float64)
N, K, DELTA, SEEDS = 50, 2, 0.05, 20
SOLVE = dict(damping=0.3, max_iter=20)


def _instances():
    "(X0, Y) of seeds 0-19, numpy (SEEDS, N, N) each."
    X0s, Ys = [], []
    for seed in range(SEEDS):
        rng = np.random.RandomState(seed)
        z0 = rng.randn(N, K)
        X0 = z0 @ z0.T / np.sqrt(N)
        E = rng.randn(N, N)
        X0s.append(X0)
        Ys.append(X0 + np.sqrt(DELTA) * (E + E.T) / np.sqrt(2))
    return np.array(X0s), np.array(Ys)


def _ratios(Xh, X0s):
    "mse_x / tau_x per lane."
    return (np.mean((Xh - X0s) ** 2, axis=(1, 2))
            / np.mean(X0s**2, axis=(1, 2)))


def test_gram_end_to_end_ep():
    X0s, Ys = _instances()
    model = (GaussianPrior(size=(N, K), **CPU) @ tt.V(id="z")
             @ LowRankGramChannel(N=N, K=K) @ tt.V(id="x")
             @ GaussianLikelihood(y=Ys[0], var=DELTA, **CPU)).to_model()
    index = next(i for i, f in enumerate(model.factors)
                 if isinstance(f, GaussianLikelihood))
    post, _ = EPSolver(model, **SOLVE).solve_batch(
        with_buffers(model, {(index, "y"): torch.as_tensor(Ys)}))
    Xh = post["x"]["r"].numpy()
    assert Xh.shape == (SEEDS, N, N) and np.all(np.isfinite(Xh))
    np.testing.assert_allclose(Xh, Xh.transpose(0, 2, 1), rtol=1e-10)
    j_models = [(JGaussianPrior(size=(N, K)) @ jt.V(id="z")
                 @ JGram(N=N, K=K) @ jt.V(id="x")
                 @ JGaussianLikelihood(y=jnp.asarray(Y), var=DELTA)
                 ).to_model() for Y in Ys]
    j_post, _ = JEPSolver(j_models[0], **SOLVE).solve_batch(
        stack_pytrees(j_models))
    port = _ratios(Xh, X0s)
    jax = _ratios(np.asarray(j_post["x"]["r"]), X0s)
    n_port, n_jax = int(np.sum(port < 0.25)), int(np.sum(jax < 0.25))
    assert n_port >= n_jax - 1, (n_port, n_jax, port, jax)
