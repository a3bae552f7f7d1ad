"""The remaining likelihoods and the analytic activations, tramp_tpu_torch
against tramp_tpu, float64 on the CPU: the sign and abs likelihoods, the
seven piecewise-linear likelihoods (relu, leaky relu, asymmetric abs, hard
tanh, hard sigmoid, symmetric door, and the generic class), the modulus
likelihood with its packed re/im axis, and the analytic abs and relu
channels. EP posteriors, messages and log partitions; an observation per
lane and a precision per lane against lane-by-lane calls; the rebuild from
the JAX factor's fields. Their state evolution is in
tests/test_torch_likelihoods_se.py.

Tolerances (torch_parity.assert_close):
- EP posteriors, messages and log partitions: rtol 1e-12 (the same
  formulas); the sign likelihood's variance is the positive belief's,
  v0 (1 + g2 - g1^2), which cancels: its isotropic mean at 1e-10;
- lanes against lane-by-lane calls, in the port: 1e-12.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu import channels as jchannels
from tramp_tpu import likelihoods as jlikelihoods

from tramp_tpu_torch import channels, convert, likelihoods

from torch_parity import assert_close, describe_factor

F64 = torch.float64
RTOL = 1e-12
N = 40

# name: (class name, keywords, y = g(z) of a standard normal z)
LIKELIHOODS = {
    "sgn": ("SgnLikelihood", {}, np.sign),
    "abs": ("AbsLikelihood", {}, np.abs),
    "relu": ("ReluLikelihood", {}, lambda z: np.maximum(z, 0.0)),
    "l-relu": ("LeakyReluLikelihood", dict(slope=0.2),
               lambda z: np.where(z < 0, 0.2 * z, z)),
    "a-abs": ("AsymmetricAbsLikelihood", dict(shift=1e-4), np.abs),
    "h-tanh": ("HardTanhLikelihood", {}, lambda z: np.clip(z, -1.0, 1.0)),
    "h-sigm": ("HardSigmoidLikelihood", {},
               lambda z: np.clip(0.5 + z / 6.0, 0.0, 1.0)),
    "door": ("SymmetricDoorLikelihood", dict(width=0.7),
             lambda z: np.where(np.abs(z) < 0.7, -1.0, 1.0)),
}


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _col(values, ndim=1):
    return _t(values).reshape((-1,) + (1,) * ndim)


def _observation(name, shape, seed=0):
    rng = np.random.RandomState(seed)
    z = 1.5 * rng.randn(*shape)
    return LIKELIHOODS[name][2](z)


def _pair(name, y):
    cls, kw, _ = LIKELIHOODS[name]
    return (getattr(likelihoods, cls)(y=y, device="cpu", dtype=F64, **kw),
            getattr(jlikelihoods, cls)(y=None if y is None
                                       else jnp.asarray(y), **kw))


def test_registry_has_every_jax_likelihood_type():
    assert set(likelihoods.LIKELIHOOD_CLASSES) == set(
        jlikelihoods.LIKELIHOOD_CLASSES)
    for key, cls in jlikelihoods.LIKELIHOOD_CLASSES.items():
        assert likelihoods.LIKELIHOOD_CLASSES[key].__name__ == cls.__name__
    assert not hasattr(likelihoods, "_WAITING")


@pytest.mark.parametrize("isotropic", [True, False])
@pytest.mark.parametrize("name", list(LIKELIHOODS))
def test_likelihood_ep(name, isotropic):
    y = _observation(name, (N,))
    cls, kw, _ = LIKELIHOODS[name]
    port = getattr(likelihoods, cls)(y=y, device="cpu", dtype=F64,
                                     isotropic=isotropic, **kw)
    ref = getattr(jlikelihoods, cls)(y=jnp.asarray(y), isotropic=isotropic,
                                     **kw)
    rng = np.random.RandomState(1)
    az, bz = 1.3, 2 * rng.randn(N)
    rtol_v = 1e-10 if name == "sgn" else RTOL
    for k, (got, want) in enumerate(zip(
            port.compute_backward_posterior(_t(az), _t(bz), port.y),
            ref.compute_backward_posterior(az, jnp.asarray(bz), ref.y))):
        assert_close(got, want, rtol_v if k else RTOL, what=f"posterior {k}")
    for got, want in zip(port.compute_backward_message(_t(az), _t(bz)),
                         ref.compute_backward_message(az, jnp.asarray(bz))):
        assert_close(got, want, rtol_v, what="message")
    assert_close(port.compute_log_partition(_t(az), _t(bz), port.y),
                 ref.compute_log_partition(az, jnp.asarray(bz), ref.y), RTOL)
    sampled = port.sample(None, _t(np.linspace(-3, 3, 13)))
    want = ref.sample(None, jnp.linspace(-3, 3, 13))
    assert_close(sampled, want, RTOL)


@pytest.mark.parametrize("name", list(LIKELIHOODS))
def test_likelihood_lanes_equal_single_calls(name):
    """An observation and a precision per lane: messages (B, n), precisions
    (B, 1); each lane as its own call."""
    B = 3
    ys = _observation(name, (B, N), seed=2)
    laned, _ = _pair(name, ys)
    rng = np.random.RandomState(3)
    az, bz = _col([0.4, 1.3, 7.0]), _t(2 * rng.randn(B, N))
    rz, vz = laned.compute_backward_posterior(az, bz, laned.y)
    a_new, b_new = laned.compute_backward_message(az, bz)
    A = laned.compute_log_partition(az, bz, laned.y)
    assert rz.shape == b_new.shape == (B, N)
    assert vz.shape == a_new.shape == A.shape == (B, 1)
    for i in range(B):
        one, _ = _pair(name, ys[i])
        r_i, v_i = one.compute_backward_posterior(az[i, 0], bz[i], one.y)
        assert_close(rz[i], r_i, 1e-12)
        assert_close(vz[i, 0], v_i, 1e-12)
        a_i, b_i = one.compute_backward_message(az[i, 0], bz[i])
        assert_close(a_new[i, 0], a_i, 1e-12)
        assert_close(b_new[i], b_i, 1e-12)
        assert_close(A[i, 0], one.compute_log_partition(az[i, 0], bz[i],
                                                        one.y), 1e-12)


def test_generic_piecewise_linear_likelihood():
    "The generic class with the regions of a three-piece ramp."
    regions = [dict(zmin=-math.inf, zmax=-0.5, x0=-0.5, slope=0.0),
               dict(zmin=-0.5, zmax=1.0, x0=0.0, slope=1.0),
               dict(zmin=1.0, zmax=math.inf, x0=1.0, slope=0.0)]
    y = np.clip(1.5 * np.random.RandomState(4).randn(N), -0.5, 1.0)
    port = likelihoods.PiecewiseLinearLikelihood("ramp", regions, y=y,
                                                 device="cpu", dtype=F64)
    ref = jlikelihoods.PiecewiseLinearLikelihood("ramp", regions,
                                                 y=jnp.asarray(y))
    assert port.region_specs == ref.region_specs and port.n_regions == 3
    bz = 2 * np.random.RandomState(5).randn(N)
    for got, want in zip(port.compute_backward_posterior(_t(0.8), _t(bz),
                                                         port.y),
                         ref.compute_backward_posterior(0.8, jnp.asarray(bz),
                                                        ref.y)):
        assert_close(got, want, RTOL)
    assert_close(port.scalar_log_partition(_t(0.8), _t(bz), port.y),
                 ref.scalar_log_partition(0.8, jnp.asarray(bz), ref.y), RTOL)


def test_piecewise_linear_merge_survives_points_outside_every_region():
    """A y a rounding error past a strict boundary lies in no region: every
    log partition is -inf there, and the merge must stay finite
    (piecewise_linear_likelihood.py:243-248)."""
    port, ref = _pair("relu", None)
    y = np.array([-1e-300, 0.0, 0.5])
    bz = np.array([0.3, -0.2, 1.0])
    got = port._merge(_t(1.1), _t(bz), _t(y))
    want = ref._merge(1.1, jnp.asarray(bz), jnp.asarray(y))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert_close(g, w, RTOL)


def _modulus_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    bz = 2 * rng.randn(*shape[:-1], 2, shape[-1])
    y = np.abs(rng.randn(*shape[:-1], shape[-1]) + 1j * rng.randn(
        *shape[:-1], shape[-1]))
    return bz, y


@pytest.mark.parametrize("isotropic", [True, False])
def test_modulus_likelihood_ep(isotropic):
    bz, y = _modulus_inputs((N,), 6)
    port = likelihoods.ModulusLikelihood(y=y, isotropic=isotropic,
                                         device="cpu", dtype=F64)
    ref = jlikelihoods.ModulusLikelihood(y=jnp.asarray(y),
                                         isotropic=isotropic)
    az = 1.7
    for got, want in zip(port.compute_backward_posterior(_t(az), _t(bz),
                                                         port.y),
                         ref.compute_backward_posterior(az, jnp.asarray(bz),
                                                        ref.y)):
        assert_close(got, want, RTOL)
    for got, want in zip(port.compute_backward_message(_t(az), _t(bz)),
                         ref.compute_backward_message(az, jnp.asarray(bz))):
        assert_close(got, want, RTOL)
    assert_close(port.compute_log_partition(_t(az), _t(bz), port.y),
                 ref.compute_log_partition(az, jnp.asarray(bz), ref.y), RTOL)
    for method in ("scalar_backward_mean", "scalar_backward_variance",
                   "scalar_log_partition"):
        assert_close(getattr(port, method)(_t(az), _t(bz), port.y),
                     getattr(ref, method)(az, jnp.asarray(bz), ref.y), RTOL,
                     what=method)
    Z = _t(np.random.RandomState(7).randn(2, N))
    assert_close(port.sample(None, Z), ref.sample(None, jnp.asarray(Z)),
                 RTOL)


def test_modulus_likelihood_packed_axis_follows_the_lanes():
    """With lanes the messages are (B, 2, N): the packed re/im axis is the
    one after the lane axis, found from the precision (B, 1, 1), also when
    B = 2."""
    for B in (2, 3):
        bz, y = _modulus_inputs((B, N), 8)
        laned = likelihoods.ModulusLikelihood(y=y, device="cpu", dtype=F64)
        az = _col([0.5, 1.7, 4.0][:B], ndim=2)
        rz, vz = laned.compute_backward_posterior(az, _t(bz), laned.y)
        a_new, b_new = laned.compute_backward_message(az, _t(bz))
        A = laned.compute_log_partition(az, _t(bz), laned.y)
        assert rz.shape == b_new.shape == (B, 2, N)
        assert vz.shape == a_new.shape == A.shape == (B, 1, 1)
        for i in range(B):
            one = likelihoods.ModulusLikelihood(y=y[i], device="cpu",
                                                dtype=F64)
            r_i, v_i = one.compute_backward_posterior(az[i, 0, 0],
                                                      _t(bz[i]), one.y)
            assert_close(rz[i], r_i, 1e-12)
            assert_close(vz[i, 0, 0], v_i, 1e-12)
            assert_close(A[i, 0, 0], one.compute_log_partition(
                az[i, 0, 0], _t(bz[i]), one.y), 1e-12)


ANALYTIC = ["AnalyticAbsChannel", "AnalyticReluChannel"]


@pytest.mark.parametrize("cls", ANALYTIC)
def test_analytic_activations(cls):
    port, ref = getattr(channels, cls)(), getattr(jchannels, cls)()
    rng = np.random.RandomState(9)
    az, bz, ax, bx = 1.7, 2 * rng.randn(N), 0.9, 2 * rng.randn(N)
    for method in ("compute_forward_posterior", "compute_backward_posterior",
                   "compute_forward_message", "compute_backward_message"):
        for got, want in zip(
                getattr(port, method)(_t(az), _t(bz), _t(ax), _t(bx)),
                getattr(ref, method)(az, jnp.asarray(bz), ax,
                                     jnp.asarray(bx))):
            assert_close(got, want, RTOL, what=method)
    assert float(port.second_moment(_t(2.0))) == pytest.approx(
        float(ref.second_moment(2.0)))
    # a precision per lane against lane-by-lane calls
    azs, axs = _col([0.5, 1.7, 6.0]), _col([0.2, 0.9, 3.0])
    bzs, bxs = _t(rng.randn(3, N)), _t(rng.randn(3, N))
    r, v = port.compute_backward_posterior(azs, bzs, axs, bxs)
    assert v.shape == (3, 1)
    for i in range(3):
        r_i, v_i = port.compute_backward_posterior(azs[i, 0], bzs[i],
                                                   axs[i, 0], bxs[i])
        assert_close(r[i], r_i, 1e-12)
        assert_close(v[i, 0], v_i, 1e-12)


@pytest.mark.parametrize("name", ["sgn", "relu", "door", "l-relu", "modulus",
                                  "AnalyticReluChannel"])
def test_likelihood_rebuilt_from_the_jax_fields(name):
    if name == "AnalyticReluChannel":
        ref = jchannels.AnalyticReluChannel()
    elif name == "modulus":
        ref = jlikelihoods.ModulusLikelihood(y=jnp.asarray(
            _modulus_inputs((N,), 10)[1]))
    else:
        ref = _pair(name, _observation(name, (N,)))[1]
    port = convert.factor_from_description(describe_factor(ref),
                                           device="cpu", dtype=F64)
    assert type(port).__name__ == type(ref).__name__
    for f in type(ref)._meta_fields:
        assert getattr(port, f) == getattr(ref, f), f
    if name == "AnalyticReluChannel":
        return
    assert port.y.dtype == F64 and port.y.shape == ref.y.shape
    bz = 2 * np.random.RandomState(11).randn(*ref.y.shape[:0], *(
        (2, N) if name == "modulus" else (N,)))
    for got, want in zip(port.compute_backward_message(_t(0.9), _t(bz)),
                         ref.compute_backward_message(0.9, jnp.asarray(bz))):
        assert_close(got, want, 1e-10)
