"""The state evolution of the remaining likelihoods, tramp_tpu_torch against
tramp_tpu, float64 on the CPU: the SE methods of the sign, abs and modulus
likelihoods (the piecewise-linear ones: tests/test_torch_pl_likelihoods_se*,
with the helpers of this file) over the (az, tau_z) grid of
tests/test_torch_se_factors.py, which includes az * tau_z = 1 and
az * tau_z < 1 (the floored measure); their measures (``b_measure``,
``bz_measure``, ``beliefs_measure``, ``measure``) and BO / RS potentials;
and a precision per lane against the same methods lane by lane. The EP
half is in tests/test_torch_likelihoods.py.

Tolerances (torch_parity.assert_close):
- SE methods and measures: rtol 1e-9 (the same nested quadratures, summed
  in another order); the overlap tau_z - v and the SE update 1/v - az are
  differences, held to 1e-9 times tau_z and az absolutely;
- lanes against lane-by-lane calls, in the port: 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu import likelihoods as jlikelihoods

from tramp_tpu_torch import likelihoods

from test_torch_likelihoods import LIKELIHOODS, _col, _t
from torch_parity import assert_close

SE_RTOL = 1e-9
AZ_TAU = [(0.5, 2.0), (1.25, 0.8), (3.0, 0.9), (1e-3, 1.0), (40.0, 0.3)]
METHODS = ("compute_backward_error", "compute_backward_state_evolution",
           "compute_free_energy", "compute_mutual_information",
           "compute_backward_overlap")
# this file's likelihoods; the piecewise-linear ones are in
# tests/test_torch_pl_likelihoods_se*.py (the JAX side's first calls of a
# likelihood compile its operations for seconds: one file would take too
# long)
NAMES = ["sgn", "abs", "modulus"]


def se_pair(name):
    "The port's and the JAX package's likelihood ``name`` with y = None."
    if name == "modulus":
        return (likelihoods.ModulusLikelihood(y=None),
                jlikelihoods.ModulusLikelihood(y=None))
    cls, kw, _ = LIKELIHOODS[name]
    return (getattr(likelihoods, cls)(y=None, **kw),
            getattr(jlikelihoods, cls)(y=None, **kw))


def jax_se_methods(names, jit=False):
    """The JAX side's SE methods over the grid, for ``names``. With ``jit``
    the five methods are one ``jax.jit`` (the grid point its argument),
    which compiles faster than the eager calls' operations one by one for
    the likelihoods with a sloped region between flat ones."""
    out = {}
    for name in names:
        _, ref = se_pair(name)

        def methods(az, tau_z, ref=ref):
            return [getattr(ref, method)(az, tau_z) for method in METHODS]

        if jit:
            methods = jax.jit(methods)
        for az, tau_z in AZ_TAU:
            for method, value in zip(METHODS, methods(az, tau_z)):
                out[name, az, tau_z, method] = np.asarray(value)
    return out


def check_se_methods(name, az, tau_z, jax_values):
    port, _ = se_pair(name)
    for method in METHODS:
        got = getattr(port, method)(_t(az), _t(tau_z))
        assert got.dtype == torch.float64
        want = jax_values[name, az, tau_z, method]
        # the overlap tau_z - v and the update 1/v - az are differences:
        # held to rtol times the terms that cancel
        scale = {"compute_backward_overlap": tau_z,
                 "compute_backward_state_evolution": az}.get(method, 0.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=SE_RTOL,
                                   atol=SE_RTOL * scale, err_msg=method)


def check_bo_rs_measures(name, potentials=True):
    """``b_measure`` and ``bz_measure`` and, with ``potentials``, the BO / RS
    methods built on them (each one more measure of another integrand).
    Without them the integrand is a plain function of (bz, y): the measures
    alone are held, and the JAX side compiles only those."""
    port, ref = se_pair(name)
    az, mz_hat, qz_hat, tz0_hat = 1.3, 0.7, 0.9, 0.4

    def f(bz, y):
        if not potentials:
            return torch.cos(0.3 * y) + 0.1 * bz + 2.0
        return port.scalar_backward_mean(_t(az), bz, y) + 2.0

    def jf(bz, y):
        if not potentials:
            return jnp.cos(0.3 * y) + 0.1 * bz + 2.0
        return ref.scalar_backward_mean(az, bz, y) + 2.0

    def jax_measures(mz_hat, qz_hat, tz0_hat):
        return [getattr(ref, measure)(mz_hat, qz_hat, tz0_hat, jf)
                for measure in ("b_measure", "bz_measure")]

    if not potentials:
        jax_measures = jax.jit(jax_measures)
    for measure, want in zip(("b_measure", "bz_measure"),
                             jax_measures(mz_hat, qz_hat, tz0_hat)):
        assert_close(
            getattr(port, measure)(_t(mz_hat), _t(qz_hat), _t(tz0_hat), f),
            want, SE_RTOL, what=measure)
    if not potentials:
        return
    for method in ("compute_backward_v_BO", "compute_potential_BO"):
        assert_close(getattr(port, method)(_t(az), _t(tz0_hat)),
                     getattr(ref, method)(az, tz0_hat), SE_RTOL, what=method)
    for got, want in zip(
            port.compute_backward_vmq_RS(_t(az), _t(mz_hat), _t(qz_hat), port,
                                         _t(tz0_hat)),
            ref.compute_backward_vmq_RS(az, mz_hat, qz_hat, ref, tz0_hat)):
        assert_close(got, want, SE_RTOL)


def check_beliefs_measure_of_a_plain_integrand(name):
    """An integrand that does not cancel, so that the whole of each measure
    counts (the error and free energy are odd or even in parts)."""
    port, ref = se_pair(name)
    az, tau_z = 2.5, 1.1
    # the sign likelihood's y is a number; the modulus likelihood hands its
    # integrand bz packed (re/im axis), which this integrand leaves out
    def f(bz, y):
        out = torch.cos(0.3 * torch.as_tensor(y, dtype=torch.float64)) + 2.0
        return out if name == "modulus" else out + 0.1 * torch.tanh(bz)

    def jf(bz, y):
        out = jnp.cos(0.3 * y) + 2.0
        return out if name == "modulus" else out + 0.1 * jnp.tanh(bz)

    assert_close(port.beliefs_measure(_t(az), _t(tau_z), f),
                 ref.beliefs_measure(az, tau_z, jf), SE_RTOL)


def check_se_lanes(name):
    """A precision and a second moment per lane, (B, 1), as the batched
    state evolution hands them: the two measures (the error and the free
    energy; the other methods are arithmetic on them) lane by lane."""
    port, _ = se_pair(name)
    az, tau = [0.5, 3.0, 40.0], [2.0, 0.9, 0.3]
    for method in ("compute_backward_error", "compute_free_energy"):
        got = getattr(port, method)(_col(az), _col(tau))
        assert got.shape == (3, 1), method
        want = [float(getattr(port, method)(_t(a), _t(t)))
                for a, t in zip(az, tau)]
        assert_close(got, np.reshape(want, (3, 1)), 1e-12, what=method)


@pytest.fixture(scope="module")
def jax_se():
    return jax_se_methods(NAMES)


@pytest.mark.parametrize("az,tau_z", AZ_TAU)
@pytest.mark.parametrize("name", NAMES)
def test_likelihood_se_methods(name, az, tau_z, jax_se):
    check_se_methods(name, az, tau_z, jax_se)


@pytest.mark.parametrize("name", ["sgn", "abs"])
def test_likelihood_bo_rs_measures(name):
    check_bo_rs_measures(name)


@pytest.mark.parametrize("name", NAMES)
def test_likelihood_beliefs_measure_of_a_plain_integrand(name):
    check_beliefs_measure_of_a_plain_integrand(name)


def test_abs_likelihood_measure():
    port, ref = se_pair("abs")
    assert_close(port.measure(_t(0.7), lambda y: torch.exp(y)),
                 ref.measure(0.7, jnp.exp), 1e-15)


@pytest.mark.parametrize("name", NAMES)
def test_likelihood_se_lanes_equal_single_calls(name):
    check_se_lanes(name)
