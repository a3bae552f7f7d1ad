"""The complex channels, tramp_tpu_torch against tramp_tpu, float64 on the
CPU: ``UnitaryChannel``, ``ComplexLinearChannel`` and ``ModulusChannel``.

Every posterior, log-partition and SE error against the JAX function at
rtol 1e-10 (torch_parity.assert_close: relative to each element with a
floor of rtol times the largest magnitude), one instance and 3 lanes (a
message ``(3, 2, n)`` with its precision ``(3, 1, 1)``, each lane against
the JAX call on that lane), and the mid-graph EP of two-layer phase
retrieval (tests/test_modulus_channel.py:125-157) against JAX (equal
n_iter, r at rtol 1e-8). The other counterparts of
tests/test_modulus_channel.py are in tests/test_torch_modulus_channel.py. The complex operators travel from JAX with their SVD
(convert.py), because the column phases of the two SVDs differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu.channels import (
    ComplexLinearChannel as JComplexLinear, ModulusChannel as JModulus,
    UnitaryChannel as JUnitary, GaussianChannel as JGaussianChannel)
from tramp_tpu.priors import GaussianPrior as JGaussianPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch import convert
from tramp_tpu_torch.channels import ModulusChannel

from torch_parity import assert_close, describe_factor, port_model

F64 = torch.float64
N, M = 12, 18


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _port(jax_factor):
    return convert.factor_from_description(describe_factor(jax_factor),
                                           device="cpu", dtype=F64)


def _complex(rng, rows, cols):
    return (rng.randn(rows, cols) + 1j * rng.randn(rows, cols)) / np.sqrt(
        2 * cols)


def _unitary(rng, n):
    q, r = np.linalg.qr(_complex(rng, n, n))
    d = np.diag(r)
    return q * (d / np.abs(d))


def _channel(kind, rng):
    if kind == "unitary":
        return JUnitary(_unitary(rng, N))
    if kind == "wide":
        return JComplexLinear(_complex(rng, N, M))
    return JComplexLinear(_complex(rng, M, N))


def _inputs(rng, nz, nx, lanes=None):
    "(az, bz, ax, bx) as numpy, one instance or ``lanes`` of them."
    lead = () if lanes is None else (lanes,)
    a_shape = () if lanes is None else (lanes, 1, 1)
    az = rng.uniform(0.5, 3.0, a_shape)
    ax = rng.uniform(0.5, 3.0, a_shape)
    return (az, rng.randn(*lead, 2, nz), ax, rng.randn(*lead, 2, nx))


def _sizes(ch):
    if isinstance(ch, JUnitary):
        return ch.N, ch.N
    return ch.Nz, ch.Nx


LINEAR = ["unitary", "tall", "wide"]


@pytest.mark.parametrize("kind", LINEAR)
def test_complex_linear_messages_and_log_partition(kind):
    rng = np.random.RandomState(LINEAR.index(kind))
    jch = _channel(kind, rng)
    ch = _port(jch)
    az, bz, ax, bx = _inputs(rng, *_sizes(jch))
    for method in ("compute_forward_message", "compute_backward_message"):
        got = getattr(ch, method)(_t(az), _t(bz), _t(ax), _t(bx))
        want = getattr(jch, method)(az, jnp.asarray(bz), ax, jnp.asarray(bx))
        for g, w in zip(got, want):
            assert_close(g, w, 1e-10, what=f"{kind} {method}")
    if kind != "unitary":
        for method in ("compute_forward_posterior",
                       "compute_backward_posterior"):
            got = getattr(ch, method)(_t(az), _t(bz), _t(ax), _t(bx))
            want = getattr(jch, method)(az, jnp.asarray(bz), ax,
                                        jnp.asarray(bx))
            for g, w in zip(got, want):
                assert_close(g, w, 1e-10, what=f"{kind} {method}")
    assert_close(ch.compute_log_partition(_t(az), _t(bz), _t(ax), _t(bx)),
                 jch.compute_log_partition(az, jnp.asarray(bz), ax,
                                           jnp.asarray(bx)), 1e-10)


@pytest.mark.parametrize("kind", LINEAR)
def test_complex_linear_with_lanes(kind):
    "3 lanes in one call against the JAX call on each lane."
    rng = np.random.RandomState(10 + LINEAR.index(kind))
    jch = _channel(kind, rng)
    ch = _port(jch)
    az, bz, ax, bx = _inputs(rng, *_sizes(jch), lanes=3)
    for method in ("compute_forward_message", "compute_backward_message",
                   "compute_log_partition"):
        got = getattr(ch, method)(_t(az), _t(bz), _t(ax), _t(bx))
        for i in range(3):
            want = getattr(jch, method)(float(az[i, 0, 0]), jnp.asarray(bz[i]),
                                        float(ax[i, 0, 0]), jnp.asarray(bx[i]))
            if method == "compute_log_partition":
                assert_close(got[i], want, 1e-10, what=f"{kind} lane {i}")
                continue
            a, b = got
            assert a.shape == (3, 1, 1) and b.shape == bx.shape[:1] + (
                b.shape[1:])
            assert_close(a[i, 0, 0], want[0], 1e-10, what=f"{kind} a {i}")
            assert_close(b[i], want[1], 1e-10, what=f"{kind} b {i}")


@pytest.mark.parametrize("kind", LINEAR)
def test_complex_linear_state_evolution(kind):
    rng = np.random.RandomState(20 + LINEAR.index(kind))
    jch = _channel(kind, rng)
    ch = _port(jch)
    tau_z = 0.7
    for az, ax in [(1.3, 0.4), (2.5, 3.0), (0.8, 0.0)]:
        for method in ("compute_forward_error", "compute_backward_error",
                       "compute_mutual_information", "compute_free_energy"):
            if kind == "unitary" and method.endswith("error"):
                continue
            assert_close(getattr(ch, method)(_t(az), _t(ax), _t(tau_z)),
                         getattr(jch, method)(az, ax, tau_z), 1e-10,
                         what=f"{kind} {method} {az} {ax}")
        for method in ("compute_forward_state_evolution",
                       "compute_backward_state_evolution"):
            assert_close(getattr(ch, method)(_t(az), _t(ax), _t(tau_z)),
                         getattr(jch, method)(az, ax, tau_z), 1e-10,
                         what=f"{kind} {method}")
    assert_close(ch.second_moment(_t(tau_z)), jch.second_moment(tau_z), 1e-12)


def test_unitary_channel_checks_its_matrix_in_float64():
    from tramp_tpu_torch.channels import UnitaryChannel
    U = _unitary(np.random.RandomState(3), 6)
    # float32 parts: the product U U^H is checked in complex128 on the host
    ch = UnitaryChannel(U, device="cpu", dtype=torch.float32)
    assert ch.U.dtype == torch.complex64 and ch.N == 6
    with pytest.raises(ValueError, match="not unitary"):
        UnitaryChannel(2 * U, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        UnitaryChannel(U[:, :4], device="cpu")


def _modulus_inputs(rng, shape, lanes=None):
    lead = () if lanes is None else (lanes,)
    a_shape = () if lanes is None else (lanes,)
    az = rng.uniform(0.5, 4.0, a_shape)
    ax = rng.uniform(0.2, 3.0, a_shape)
    return (az, 2 * rng.randn(*lead, 2, *shape), ax,
            2 * rng.randn(*lead, *shape))


@pytest.mark.parametrize("isotropic", [True, False])
def test_modulus_channel_posteriors_and_log_partition(isotropic):
    rng = np.random.RandomState(30 + isotropic)
    jch, ch = JModulus(isotropic=isotropic), ModulusChannel(isotropic)
    az, bz, ax, bx = _modulus_inputs(rng, (N,))
    args = (_t(az), _t(bz), _t(ax), _t(bx))
    jargs = (az, jnp.asarray(bz), ax, jnp.asarray(bx))
    for method in ("compute_backward_posterior", "compute_forward_posterior",
                   "compute_forward_message", "compute_backward_message"):
        for g, w in zip(getattr(ch, method)(*args),
                        getattr(jch, method)(*jargs)):
            assert_close(g, w, 1e-10, what=method)
    for method in ("compute_log_partition", "scalar_log_partition",
                   "scalar_backward_mean", "scalar_backward_variance",
                   "scalar_forward_mean", "scalar_forward_variance"):
        assert_close(getattr(ch, method)(*args),
                     getattr(jch, method)(*jargs), 1e-10, what=method)


def test_modulus_channel_with_lanes():
    """3 lanes: z ``(3, 2, N)`` with precision ``(3, 1, 1)``, x ``(3, N)``
    with ``(3, 1)``; each lane against the JAX call on its own data."""
    rng = np.random.RandomState(32)
    jch, ch = JModulus(), ModulusChannel()
    az, bz, ax, bx = _modulus_inputs(rng, (N,), lanes=3)
    az_l, ax_l = _t(az).reshape(3, 1, 1), _t(ax).reshape(3, 1)
    fwd = ch.compute_forward_message(az_l, _t(bz), ax_l, _t(bx))
    bwd = ch.compute_backward_message(az_l, _t(bz), ax_l, _t(bx))
    logZ = ch.compute_log_partition(az_l, _t(bz), ax_l, _t(bx))
    assert fwd[0].shape == (3, 1) and bwd[0].shape == (3, 1, 1)
    assert fwd[1].shape == (3, N) and bwd[1].shape == (3, 2, N)
    for i in range(3):
        jargs = (float(az[i]), jnp.asarray(bz[i]), float(ax[i]),
                 jnp.asarray(bx[i]))
        for got, want in ((fwd, jch.compute_forward_message(*jargs)),
                          (bwd, jch.compute_backward_message(*jargs))):
            assert_close(got[0][i].reshape(()), want[0], 1e-10)
            assert_close(got[1][i], want[1], 1e-10)
        assert_close(logZ[i], jch.compute_log_partition(*jargs), 1e-10)


#: (az, ax): a typical point, and one with az tau_z < 1 (the measure's
#: special case)
SE_POINTS = [(2.0, 1.0), (1.0, 0.3)]


def test_modulus_channel_state_evolution():
    """SE errors and the mutual information (through the free energy)
    against JAX at the typical point, the backward SE update (an error and
    the moment matching) at the special one."""
    jch, ch = JModulus(), ModulusChannel()
    tau_z = 0.7
    az, ax = SE_POINTS[0]
    for method in ("compute_backward_error", "compute_forward_error",
                   "compute_mutual_information"):
        assert_close(getattr(ch, method)(_t(az), _t(ax), _t(tau_z)),
                     getattr(jch, method)(az, ax, tau_z), 1e-10,
                     what=f"{method} at {az}, {ax}")
    # a_new = 1/v - a cancels where v ~ 1/a: held at the scale of the
    # cancelled terms
    az, ax = SE_POINTS[1]
    np.testing.assert_allclose(
        ch.compute_backward_state_evolution(_t(az), _t(ax), _t(tau_z)),
        jch.compute_backward_state_evolution(az, ax, tau_z), rtol=1e-10,
        atol=1e-10 * az)


def test_modulus_channel_state_evolution_with_lanes():
    "The SE points as 2 lanes, (2, 1) precisions, in one call."
    jch, ch = JModulus(), ModulusChannel()
    tau_z = 0.7
    az = _t([p[0] for p in SE_POINTS]).reshape(2, 1)
    ax = _t([p[1] for p in SE_POINTS]).reshape(2, 1)
    got = ch.compute_backward_error(az, ax, _t(tau_z))
    assert got.shape == (2, 1)
    for i, (a, x) in enumerate(SE_POINTS):
        assert_close(got[i, 0], jch.compute_backward_error(a, x, tau_z),
                     1e-10, what=f"lane {i}")


def test_modulus_channel_mid_graph_ep():
    """Two-layer phase retrieval, x complex -> W (complex) -> |.| -> + noise
    -> y, the JAX test's model, through the engine on both sides: equal
    n_iter, r and v at rtol 1e-8, and the phase-invariant MSE under half
    the signal's power."""
    Nx, Mz = 64, 192
    W = (jax.random.normal(jax.random.PRNGKey(0), (Mz, Nx)) + 1j
         * jax.random.normal(jax.random.PRNGKey(1), (Mz, Nx))) / jnp.sqrt(
             2 * Nx)
    teacher = (
        JGaussianPrior(size=(2, Nx), mean=0.3) @ jt.V(id="x") @
        JComplexLinear(W, name="W") @ jt.V(id="z") @
        JModulus() @ jt.V(id="a") @
        JGaussianChannel(var=1e-4) @ jt.O(id="y")
    ).to_model()
    sample = teacher.sample(jax.random.PRNGKey(2))
    j_student = teacher.to_observed({"y": sample["y"]})
    student = port_model(j_student)
    j_ep = jt.ExpectationPropagation(j_student)
    j_ep.iterate(max_iter=200, damping=0.3)
    ep = tt.ExpectationPropagation(student).iterate(max_iter=200, damping=0.3)
    assert ep.n_iter == j_ep.n_iter
    for id in ("x", "z", "a"):
        d, j_d = ep.get_variable_data(id), j_ep.get_variable_data(id)
        assert_close(d["r"], j_d["r"], 1e-8, what=id)
        assert_close(d["v"], j_d["v"], 1e-8, what=id)
    r = ep.get_variable_data("x")["r"].numpy()
    x0 = np.asarray(sample["x"])
    xhat, xt = r[0] + 1j * r[1], x0[0] + 1j * x0[1]
    phase = np.vdot(xhat, xt) / max(abs(np.vdot(xhat, xt)), 1e-30)
    mse = np.mean(np.abs(xt - phase * xhat) ** 2) / 2
    assert mse < 0.5 * np.mean(np.abs(xt) ** 2) / 2
