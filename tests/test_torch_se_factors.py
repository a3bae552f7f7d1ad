"""The state-evolution methods of the ported factors, tramp_tpu_torch
against tramp_tpu, float64 on the CPU: second moments, errors, SE updates,
free energies, mutual informations and the measures (``b_measure``,
``bx_measure``, ``bz_measure``, ``beliefs_measure``) of the Gauss-Bernoulli
prior, the Gaussian likelihood and channel, and the dense, the analytical
and the Marchenko-Pastur linear channels, over a grid of (az, ax, tau_z)
that includes ax = 0 and az * tau_z = 1 (the degenerate covariances of the
measure). The piecewise-linear channels are in
tests/test_torch_se_pl_channel.py.

Tolerances (torch_parity.assert_close):
- SE methods of the factors: rtol 1e-9 (quadrature sums of 10^4 nodes in
  another order, a 2 x 2 Cholesky written out);
- lanes against the same methods called lane by lane, in the port: 1e-12.
A free energy that is 0 in exact arithmetic (ax = 0) is held to 1e-12
absolutely: both sides return roundoff there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu import channels as jchannels
from tramp_tpu.ensembles import MarchenkoPasturEnsemble as JMPEnsemble
from tramp_tpu.likelihoods import GaussianLikelihood as JGaussianLikelihood
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

from tramp_tpu_torch import channels
from tramp_tpu_torch.ensembles import MarchenkoPasturEnsemble
from tramp_tpu_torch.likelihoods import GaussianLikelihood
from tramp_tpu_torch.priors import GaussBernoulliPrior

from torch_parity import assert_close

F64 = torch.float64
RTOL = 1e-9


def _t(x):
    return torch.as_tensor(x, dtype=F64)


def _col(values):
    return torch.as_tensor(np.asarray(values), dtype=F64).reshape(-1, 1)


# -- prior -------------------------------------------------------------------

PRIORS = {"zero_mean": dict(rho=0.25), "shifted": dict(rho=0.6, mean=0.4,
                                                       var=1.7)}
AX = [0.0, 1e-3, 0.8, 30.0, 4e3]


@pytest.mark.parametrize("ax", AX)
@pytest.mark.parametrize("name", list(PRIORS))
def test_prior_se_methods(name, ax):
    port = GaussBernoulliPrior(size=1, device="cpu", **PRIORS[name])
    ref = JGaussBernoulliPrior(size=1, **PRIORS[name])
    assert port.second_moment() == pytest.approx(float(ref.second_moment()),
                                                 rel=1e-15)
    for method in ("compute_forward_error", "compute_forward_state_evolution",
                   "compute_free_energy", "compute_mutual_information",
                   "compute_forward_overlap"):
        got, want = getattr(port, method)(_t(ax)), getattr(ref, method)(ax)
        if ax == 0 and method in ("compute_free_energy",
                                  "compute_mutual_information"):
            assert abs(float(got) - float(want)) < 1e-12, method
            continue
        assert_close(got, want, RTOL, what=method)


@pytest.mark.parametrize("name", list(PRIORS))
def test_prior_measures_and_potentials(name):
    port = GaussBernoulliPrior(size=1, device="cpu", **PRIORS[name])
    ref = JGaussBernoulliPrior(size=1, **PRIORS[name])
    ax, mx_hat, qx_hat, tx0_hat = 1.3, 0.7, 0.9, 0.4
    for measure in ("b_measure", "bx_measure"):
        got = getattr(port, measure)(
            _t(mx_hat), _t(qx_hat), _t(tx0_hat),
            lambda bx: port.scalar_forward_mean(_t(ax), bx) + 2.0)
        want = getattr(ref, measure)(
            mx_hat, qx_hat, tx0_hat,
            lambda bx: ref.scalar_forward_mean(ax, bx) + 2.0)
        assert_close(got, want, RTOL, what=measure)
    assert_close(
        port.beliefs_measure(_t(ax), lambda bx: torch.tanh(bx) + 2.0),
        ref.beliefs_measure(ax, lambda bx: jnp.tanh(bx) + 2.0), RTOL)
    assert_close(port.measure(lambda x: torch.cos(x)), ref.measure(jnp.cos),
                 RTOL)
    assert_close(port.compute_forward_v_BO(_t(ax), _t(tx0_hat)),
                 ref.compute_forward_v_BO(ax, tx0_hat), RTOL)
    assert_close(port.compute_potential_BO(_t(ax), _t(tx0_hat)),
                 ref.compute_potential_BO(ax, tx0_hat), RTOL)
    for got, want in zip(
            port.compute_forward_vmq_RS(_t(ax), _t(mx_hat), _t(qx_hat), port,
                                        _t(tx0_hat)),
            ref.compute_forward_vmq_RS(ax, mx_hat, qx_hat, ref, tx0_hat)):
        assert_close(got, want, RTOL)
    assert_close(port.forward_second_moment_FG(_t(tx0_hat)),
                 ref.forward_second_moment_FG(tx0_hat), RTOL)
    assert_close(port.prior_log_partition_FG(_t(tx0_hat)),
                 ref.prior_log_partition_FG(tx0_hat), RTOL)
    # the bisection, a few steps of it (each is one quadrature)
    assert_close(port.compute_precision(_t(0.1), n_steps=6),
                 ref.compute_precision(jnp.asarray(0.1), n_steps=6), RTOL)
    rng = np.random.RandomState(0)
    bx = rng.randn(40)
    assert_close(port.compute_log_partition(_t(ax), _t(bx)),
                 ref.compute_log_partition(ax, jnp.asarray(bx)), 1e-12)


def test_prior_lanes_equal_single_calls_and_eta_is_a_number():
    """Per-lane rho, mean and var: every method gives lane by lane what the
    prior of that lane's numbers gives. With numbers ``eta`` is a Python
    float (no tensor is built), with lanes a tensor."""
    rho, mean, var = [0.1, 0.25, 0.6], [0.0, 0.3, -0.2], [1.0, 1.7, 0.5]
    laned = GaussBernoulliPrior(size=1, rho=_col(rho), mean=_col(mean),
                                var=_col(var), device="cpu")
    singles = [GaussBernoulliPrior(size=1, rho=r, mean=m, var=v, device="cpu")
               for r, m, v in zip(rho, mean, var)]
    assert all(type(p.eta) is float for p in singles)
    assert laned.eta.shape == (3, 1)
    ax = [0.0, 0.8, 30.0]
    for method in ("compute_forward_error", "compute_forward_state_evolution",
                   "compute_free_energy", "compute_mutual_information"):
        got = getattr(laned, method)(_col(ax))
        want = [float(getattr(p, method)(_t(a))) for p, a in zip(singles, ax)]
        assert got.shape == (3, 1)
        assert_close(got, np.reshape(want, (3, 1)), 1e-12, what=method)
    got = laned.second_moment()
    assert_close(got, np.reshape([p.second_moment() for p in singles],
                                 (3, 1)), 1e-15)
    # the EP posterior of a batch with a sparsity per lane
    rng = np.random.RandomState(1)
    bx = _t(rng.randn(3, 50))
    r, v = laned.compute_forward_posterior(_col([1.0, 2.0, 0.5]), bx)
    for i, p in enumerate(singles):
        r_i, v_i = p.compute_forward_posterior(_t([1.0, 2.0, 0.5][i]), bx[i])
        assert_close(r[i], r_i, 1e-12)
        assert_close(v[i, 0], v_i, 1e-12)


# -- likelihood ---------------------------------------------------------------

AZ_TAU = [(0.5, 2.0), (1.25, 0.8), (3.0, 0.9), (1e-3, 1.0), (40.0, 0.3)]


@pytest.mark.parametrize("az,tau_z", AZ_TAU)
def test_gaussian_likelihood_se_methods(az, tau_z):
    port = GaussianLikelihood(y=None, var=0.3, device="cpu")
    ref = JGaussianLikelihood(y=None, var=0.3)
    for method in ("compute_backward_error", "compute_free_energy",
                   "compute_backward_state_evolution",
                   "compute_mutual_information", "compute_backward_overlap",
                   "compute_backward_v_BO"):
        assert_close(getattr(port, method)(_t(az), _t(tau_z)),
                     getattr(ref, method)(az, tau_z), RTOL, what=method)
    # the generic quadrature forms of the base class against the closed ones
    base = super(GaussianLikelihood, port)
    jbase = super(JGaussianLikelihood, ref)
    for method in ("compute_backward_error", "compute_free_energy",
                   "compute_mutual_information"):
        assert_close(getattr(base, method)(_t(az), _t(tau_z)),
                     getattr(jbase, method)(az, tau_z), RTOL, what=method)


def test_gaussian_likelihood_measures():
    port = GaussianLikelihood(y=None, var=0.3, device="cpu")
    ref = JGaussianLikelihood(y=None, var=0.3)
    az, mz_hat, qz_hat, tz0_hat = 1.3, 0.7, 0.9, 0.4

    def f(bz, y):
        return port.scalar_backward_mean(_t(az), bz, y) + 2.0

    def jf(bz, y):
        return ref.scalar_backward_mean(az, bz, y) + 2.0

    for measure in ("b_measure", "bz_measure"):
        assert_close(
            getattr(port, measure)(_t(mz_hat), _t(qz_hat), _t(tz0_hat), f),
            getattr(ref, measure)(mz_hat, qz_hat, tz0_hat, jf), RTOL,
            what=measure)
    for tau_z in (2.0, 1.0 / az):
        assert_close(port.beliefs_measure(_t(az), _t(tau_z), f),
                     ref.beliefs_measure(az, tau_z, jf), RTOL)
    assert_close(port.measure(_t(0.4), torch.cos), ref.measure(0.4, jnp.cos),
                 RTOL)
    for got, want in zip(
            port.compute_backward_vmq_RS(_t(az), _t(mz_hat), _t(qz_hat), port,
                                         _t(tz0_hat)),
            ref.compute_backward_vmq_RS(az, mz_hat, qz_hat, ref, tz0_hat)):
        assert_close(got, want, RTOL)
    rng = np.random.RandomState(0)
    bz, y = rng.randn(40), rng.randn(40)
    assert_close(port.compute_log_partition(_t(az), _t(bz), _t(y)),
                 ref.compute_log_partition(az, jnp.asarray(bz),
                                           jnp.asarray(y)), 1e-12)


def test_gaussian_likelihood_lanes():
    var, az, tau = [0.3, 1e-2, 2.0], [0.5, 3.0, 40.0], [2.0, 0.9, 0.3]
    laned = GaussianLikelihood(y=None, var=_col(var), device="cpu")
    for method in ("compute_backward_error", "compute_free_energy",
                   "compute_backward_state_evolution",
                   "compute_mutual_information"):
        got = getattr(laned, method)(_col(az), _col(tau))
        want = [float(getattr(GaussianLikelihood(y=None, var=v, device="cpu"),
                              method)(_t(a), _t(t)))
                for v, a, t in zip(var, az, tau)]
        assert_close(got, np.reshape(want, (3, 1)), 1e-12, what=method)


# -- linear channels ----------------------------------------------------------

# (az, ax, tau_z): generic, ax = 0, az * tau_z = 1, large precisions
GRID = [(1.7, 0.9, 1.2), (0.8, 0.0, 2.0), (2.0, 0.6, 0.5), (25.0, 40.0, 0.3)]
LINEAR = ["gaussian", "dense", "marchenko", "analytical"]


def _linear_pair(kind):
    if kind == "gaussian":
        return (channels.GaussianChannel(var=0.3),
                jchannels.GaussianChannel(var=0.3))
    if kind == "dense":
        W = np.random.RandomState(5).randn(12, 20) / np.sqrt(20)
        return (channels.LinearChannel(W, device="cpu", dtype=F64),
                jchannels.LinearChannel(jnp.asarray(W)))
    if kind == "marchenko":
        return (channels.MarchenkoPasturChannel(alpha=0.6),
                jchannels.MarchenkoPasturChannel(alpha=0.6))
    return (channels.AnalyticalLinearChannel(MarchenkoPasturEnsemble(1.4)),
            jchannels.AnalyticalLinearChannel(JMPEnsemble(1.4)))


@pytest.mark.parametrize("az,ax,tau_z", GRID)
@pytest.mark.parametrize("kind", LINEAR)
def test_linear_channels_se_methods(kind, az, ax, tau_z):
    port, ref = _linear_pair(kind)
    methods = ["compute_forward_state_evolution",
               "compute_backward_state_evolution", "second_moment"]
    if kind != "gaussian":
        methods += ["compute_forward_error", "compute_backward_error"]
    if ax > 0:   # the mutual information takes log(ax / az)
        methods += ["compute_mutual_information", "compute_free_energy"]
    for method in methods:
        args = (tau_z,) if method == "second_moment" else (az, ax, tau_z)
        assert_close(getattr(port, method)(*map(_t, args)),
                     getattr(ref, method)(*args), RTOL, what=method)


def test_marchenko_pastur_dual_and_ensemble():
    port, ref = _linear_pair("marchenko")
    vz, vx, tau_z = 0.4, 0.25, 1.2
    for got, want in zip(port.compute_precision(_t(vz), _t(vx), _t(tau_z)),
                         ref.compute_precision(vz, vx, tau_z)):
        assert_close(got, want, RTOL)
    assert_close(port.compute_dual_mutual_information(_t(vz), _t(vx),
                                                      _t(tau_z)),
                 ref.compute_dual_mutual_information(vz, vx, tau_z), RTOL)
    assert_close(port.compute_dual_free_energy(_t(0.3), _t(0.5), _t(tau_z)),
                 ref.compute_dual_free_energy(0.3, 0.5, tau_z), RTOL)
    for alpha in (0.6, 1.4):
        e, je = MarchenkoPasturEnsemble(alpha), JMPEnsemble(alpha)
        assert e.mean_spectrum == pytest.approx(float(je.mean_spectrum),
                                                rel=1e-12)
        gamma = np.array([1e-3, 0.5, 20.0])
        for method in ("eta_transform", "shannon_transform"):
            assert_close(getattr(e, method)(_t(gamma)),
                         getattr(je, method)(jnp.asarray(gamma)), 1e-12)


def test_marchenko_pastur_lanes():
    alpha, az, ax, tau = [0.3, 1.0, 1.8], [1.7, 0.8, 25.0], [0.9, 0.0, 40.0], \
        [1.2, 2.0, 0.3]
    laned = channels.MarchenkoPasturChannel(alpha=_col(alpha))
    for method in ("compute_forward_state_evolution",
                   "compute_backward_state_evolution"):
        got = getattr(laned, method)(_col(az), _col(ax), _col(tau))
        want = [float(getattr(channels.MarchenkoPasturChannel(alpha=al),
                              method)(_t(a), _t(x), _t(t)))
                for al, a, x, t in zip(alpha, az, ax, tau)]
        assert_close(got, np.reshape(want, (3, 1)), 1e-12, what=method)
    assert laned.second_moment(_t(0.7)).shape == (3, 1)


def test_gaussian_and_dense_channel_log_partition():
    rng = np.random.RandomState(2)
    az, ax = 1.7, 0.9
    for kind, nz, nx in (("gaussian", 30, 30), ("dense", 20, 12)):
        port, ref = _linear_pair(kind)
        bz, bx = rng.randn(nz), rng.randn(nx)
        assert_close(
            port.compute_log_partition(_t(az), _t(bz), _t(ax), _t(bx)),
            ref.compute_log_partition(az, jnp.asarray(bz), ax,
                                      jnp.asarray(bx)), 1e-12, what=kind)
