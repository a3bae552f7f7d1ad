"""The slice's factors and the math under them, tramp_tpu_torch against
tramp_tpu, float64 on the CPU: the EP posteriors and messages of the
Gauss-Bernoulli prior, the linear channel (k < Nz and k = Nz, with its
spectral-carry helpers), the piecewise-linear channels, the Gaussian channel
and likelihood; the beliefs; the truncated-normal moments in every regime;
erfcx and log_Phi_erfcx at both ends.

Tolerances (torch_parity.assert_close: relative to each element, with a
floor of rtol times the array's largest finite magnitude):
- factor posteriors and messages, beliefs, truncated-normal mean, logZ and
  log P: rtol 1e-12 (the same formulas; only elementwise roundoff and the
  summation order of small matvecs differ);
- the truncated-normal variance v0 (1 + g2 - g1^2) and probability
  Phi(y) - Phi(x) are differences of larger terms: 1e-12 times those terms'
  magnitude, v0 (1 + |g2| + g1^2) and 1;
- erfcx and log_Phi_erfcx: rtol 1e-12 in float64 and 1e-5 in float32 (a few
  float32 ulps of exp(x^2) near the direct-formula limit |x| = 9),
  elementwise with no floor, infinities matching exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu import base as jbase
from tramp_tpu.beliefs import normal as jnormal, sparse as jsparse
from tramp_tpu import channels as jchannels
from tramp_tpu.likelihoods import GaussianLikelihood as JGaussianLikelihood
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior
from tramp_tpu.utils import special as jspecial
from tramp_tpu.utils import truncated_normal as jtn

from tramp_tpu_torch import base, channels, convert
from tramp_tpu_torch.beliefs import normal, sparse
from tramp_tpu_torch.likelihoods import GaussianLikelihood
from tramp_tpu_torch.priors import GaussBernoulliPrior
from tramp_tpu_torch.utils import special, truncated_normal as tn

from torch_parity import assert_close, describe_factor

F64 = torch.float64
RTOL = 1e-12


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _inputs(n, seed=0):
    "(az, bz, ax, bx) as numpy: scalar precisions, array b's."
    rng = np.random.RandomState(seed)
    return 1.7, 2 * rng.randn(n), 0.9, 2 * rng.randn(n)


def test_base_updates():
    rng = np.random.RandomState(3)
    r, b = rng.randn(40), rng.randn(40)
    v = np.concatenate([rng.rand(39) + 1e-3, [0.0]])  # one below VMIN
    a = 0.3
    assert_close(base.inv(_t(v)), jbase.inv(jnp.asarray(v)), RTOL)
    assert_close(base.compute_a_new(_t(v), _t(a)),
                 jbase.compute_a_new(jnp.asarray(v), a), RTOL)
    for got, want in zip(
            base.compute_ab_new(_t(r), _t(v), _t(a), _t(b)),
            jbase.compute_ab_new(jnp.asarray(r), jnp.asarray(v), a,
                                 jnp.asarray(b))):
        assert_close(got, want, RTOL)


@pytest.mark.parametrize("module", ["normal", "sparse"])
def test_beliefs(module):
    rng = np.random.RandomState(4)
    a, b = 0.5 + rng.rand(50), 3 * rng.randn(50)
    args = () if module == "normal" else (0.8,)
    port, ref = (normal, jnormal) if module == "normal" else (sparse, jsparse)
    names = ("A", "r", "v", "tau") + (("p",) if module == "sparse" else ())
    for name in names:
        assert_close(getattr(port, name)(_t(a), _t(b), *args),
                     getattr(ref, name)(jnp.asarray(a), jnp.asarray(b),
                                        *args), RTOL, what=name)


@pytest.mark.parametrize("isotropic", [True, False])
def test_gauss_bernoulli_prior(isotropic):
    n = 64
    _, _, ax, bx = _inputs(n, seed=5)
    kw = dict(size=n, rho=0.3, mean=0.2, var=1.5, isotropic=isotropic)
    port = GaussBernoulliPrior(**kw, device="cpu", dtype=F64)
    ref = JGaussBernoulliPrior(**kw)
    assert port.eta == pytest.approx(float(ref.eta), rel=RTOL)
    for method in ("compute_forward_posterior", "compute_forward_message"):
        for got, want in zip(getattr(port, method)(_t(ax), _t(bx)),
                             getattr(ref, method)(ax, jnp.asarray(bx))):
            assert_close(got, want, RTOL, what=method)
    x = port.sample(torch.Generator().manual_seed(0))
    assert x.shape == (n,) and x.dtype == F64


def _linear_pair(shape, own_svd=False):
    rng = np.random.RandomState(6)
    W = rng.randn(*shape) / np.sqrt(shape[1])
    ref = jchannels.LinearChannel(jnp.asarray(W))
    if own_svd:  # torch's SVD: other column signs, same posteriors
        port = channels.LinearChannel(W, device="cpu", dtype=F64)
    else:
        port = convert.factor_from_description(describe_factor(ref),
                                               device="cpu", dtype=F64)
    return port, ref


LINEAR_SHAPES = {"k_lt_Nz": (30, 50), "k_eq_Nz": (50, 30)}


@pytest.mark.parametrize("ax", [0.7, 0.0], ids=["ax", "ax0"])
@pytest.mark.parametrize("shape", list(LINEAR_SHAPES))
def test_linear_channel(shape, ax):
    port, ref = _linear_pair(LINEAR_SHAPES[shape])
    Nx, Nz = LINEAR_SHAPES[shape]
    assert (port.k, port.rank) == (ref.k, ref.rank)
    rng = np.random.RandomState(7)
    az, bz, bx = 1.3, rng.randn(Nz), rng.randn(Nx)
    args_p = (_t(az), _t(bz), _t(ax), _t(bx))
    args_j = (az, jnp.asarray(bz), ax, jnp.asarray(bx))
    for method in ("compute_forward_posterior", "compute_backward_posterior",
                   "compute_forward_message", "compute_backward_message"):
        for got, want in zip(getattr(port, method)(*args_p),
                             getattr(ref, method)(*args_j)):
            assert_close(got, want, RTOL, what=method)


@pytest.mark.parametrize("shape", list(LINEAR_SHAPES))
def test_linear_spectral_helpers(shape):
    port, ref = _linear_pair(LINEAR_SHAPES[shape])
    Nx, Nz = LINEAR_SHAPES[shape]
    rng = np.random.RandomState(8)
    az, ax, bz, bx = 1.3, 0.6, rng.randn(Nz), rng.randn(Nx)
    u_p = port.spectral_image(_t(bx))
    u_j = ref.spectral_image(jnp.asarray(bx))
    assert_close(u_p, u_j, RTOL, what="U^T bx")
    for got, want in zip(
            port.spectral_forward_posterior(_t(az), _t(bz), _t(ax), u_p),
            ref.spectral_forward_posterior(az, jnp.asarray(bz), ax, u_j)):
        assert_close(got, want, RTOL, what="spectral forward")
    for got, want in zip(
            port.spectral_backward_posterior(_t(az), _t(bz), _t(ax), _t(bx)),
            ref.spectral_backward_posterior(az, jnp.asarray(bz), ax,
                                            jnp.asarray(bx))):
        assert_close(got, want, RTOL, what="spectral backward")


def test_linear_channel_own_svd():
    "Posteriors do not depend on the SVD's column signs."
    port, ref = _linear_pair(LINEAR_SHAPES["k_lt_Nz"], own_svd=True)
    rng = np.random.RandomState(9)
    az, ax, bz, bx = 1.3, 0.6, rng.randn(50), rng.randn(30)
    for method in ("compute_forward_posterior", "compute_backward_posterior"):
        for got, want in zip(
                getattr(port, method)(_t(az), _t(bz), _t(ax), _t(bx)),
                getattr(ref, method)(az, jnp.asarray(bz), ax,
                                     jnp.asarray(bx))):
            assert_close(got, want, RTOL, what=method)


PL_CHANNELS = {
    "sgn": ("SgnChannel", {}), "abs": ("AbsChannel", {}),
    "a-abs": ("AsymmetricAbsChannel", {"shift": 0.1}),
    "relu": ("ReluChannel", {}), "l-relu": ("LeakyReluChannel", {"slope": 0.3}),
    "h-tanh": ("HardTanhChannel", {}), "h-sigm": ("HardSigmoidChannel", {}),
    "door": ("SymmetricDoorChannel", {"width": 0.7}),
}


@pytest.mark.parametrize("name", list(PL_CHANNELS))
def test_piecewise_linear_channel(name):
    cls, kw = PL_CHANNELS[name]
    port = getattr(channels, cls)(**kw)
    ref = getattr(jchannels, cls)(**kw)
    assert port.region_specs == ref.region_specs
    az, bz, ax, bx = _inputs(200, seed=10)
    args_p = (_t(az), _t(bz), _t(ax), _t(bx))
    args_j = (az, jnp.asarray(bz), ax, jnp.asarray(bx))
    for method in ("compute_forward_posterior", "compute_backward_posterior",
                   "compute_forward_message", "compute_backward_message"):
        for got, want in zip(getattr(port, method)(*args_p),
                             getattr(ref, method)(*args_j)):
            assert_close(got, want, RTOL, what=method)
    Z = np.random.RandomState(11).randn(100)
    assert_close(port.sample(None, _t(Z)),
                 ref.sample(jax.random.PRNGKey(0), jnp.asarray(Z)), 0.0,
                 what="sample")


def test_gaussian_channel():
    port, ref = channels.GaussianChannel(var=0.3), jchannels.GaussianChannel(
        var=0.3)
    az, bz, ax, bx = _inputs(80, seed=12)
    args_p = (_t(az), _t(bz), _t(ax), _t(bx))
    args_j = (az, jnp.asarray(bz), ax, jnp.asarray(bx))
    for method in ("compute_forward_posterior", "compute_backward_posterior",
                   "compute_forward_message", "compute_backward_message"):
        for got, want in zip(getattr(port, method)(*args_p),
                             getattr(ref, method)(*args_j)):
            assert_close(got, want, RTOL, what=method)


def test_gaussian_likelihood():
    rng = np.random.RandomState(13)
    y, bz, az = rng.randn(80), rng.randn(80), 0.7
    port = GaussianLikelihood(y=y, var=0.05, device="cpu", dtype=F64)
    ref = JGaussianLikelihood(y=jnp.asarray(y), var=0.05)
    for got, want in zip(
            port.compute_backward_posterior(_t(az), _t(bz), port.y),
            ref.compute_backward_posterior(az, jnp.asarray(bz), ref.y)):
        assert_close(got, want, RTOL, what="posterior")
    for got, want in zip(
            port.compute_backward_message(_t(az), _t(bz)),
            ref.compute_backward_message(jnp.asarray(az), jnp.asarray(bz))):
        assert_close(got, want, RTOL, what="message")
# (zmin, zmax) per regime of F0/F1/F2 at x, y = (z - r0)/sqrt(v0)/sqrt2
# with r0 ~ 2 N(0, 1): both bounds far below r0 (neg), far above (pos),
# around it (other), a width-1e-8 interval (close), and the infinite cases
REGIMES = {
    "close": (0.3, 0.3 + 1e-8),
    "neg": (-14.0, -12.0),
    "pos": (12.0, 14.0),
    "other": (-1.0, 1.0),
    "upper_inf": (0.5, math.inf),
    "lower_inf": (-math.inf, -0.5),
    "both_inf": (-math.inf, math.inf),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_truncated_normal_regimes(regime):
    """mean, logZ and log P at rtol 1e-12. The variance v0 (1 + g2 - g1^2)
    and the probability Phi(y) - Phi(x) are differences of larger terms,
    so their tolerance is 1e-12 times those terms' magnitude:
    v0 (1 + |g2| + g1^2) and 1."""
    zmin, zmax = REGIMES[regime]
    rng = np.random.RandomState(1)
    r0 = 2 * rng.randn(64)
    v0 = 0.5 + rng.rand(64)
    t_r0, t_v0 = torch.as_tensor(r0), torch.as_tensor(v0)
    j_r0, j_v0 = jnp.asarray(r0), jnp.asarray(v0)

    def both(name):
        got = getattr(tn, name)(t_r0, t_v0, zmin, zmax)
        want = getattr(jtn, name)(j_r0, j_v0, zmin, zmax)
        return (np.broadcast_to(np.asarray(got), r0.shape),
                np.broadcast_to(np.asarray(want), r0.shape))

    for name in ("truncated_normal_mean", "truncated_normal_logZ",
                 "truncated_normal_log_proba"):
        assert_close(*both(name), 1e-12, what=name)
    g1 = np.asarray(jtn._g1(j_r0, j_v0, zmin, zmax))
    g2 = np.asarray(jtn._g2(j_r0, j_v0, zmin, zmax))
    got, want = both("truncated_normal_var")
    np.testing.assert_array_less(
        np.abs(got - want), 1e-12 * v0 * (1 + np.abs(g2) + g1**2) + 1e-300)
    got, want = both("truncated_normal_proba")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# both ends: overflow to +inf below x ~ -26.6 (f64) / -9.4 (f32), the
# asymptotic series above the direct-formula limit, the +-1e15 clamp of
# log_Phi_erfcx and +-inf
_X = np.concatenate([
    -np.logspace(-3, 2.5, 40), np.logspace(-3, 2.5, 40),
    [0.0, -1e20, 1e20, -np.inf, np.inf, 8.9, 9.1, 24.9, 25.1, -26.0, -27.0]])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("fn", ["erfcx", "log_Phi_erfcx"])
def test_special_functions(fn, dtype):
    x = _X.astype(dtype)
    got = getattr(special, fn)(torch.as_tensor(x)).numpy()
    want = np.asarray(getattr(jspecial, fn)(jnp.asarray(x)))
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, atol=0,
                               rtol=1e-12 if dtype == "float64" else 1e-5)
