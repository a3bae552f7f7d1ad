"""The counterparts of tests/test_modulus_channel.py on the port's
``ModulusChannel``, float64 on the CPU, with that file's oracles and
tolerances: the brute-force grid integration over the complex plane, the
conjugacy of the quadrature log-partition (torch.autograd), the normalised
beliefs measure, the SE errors against the Bayes-optimal Monte Carlo
ensemble, and the mutual information at the zero-information point. The
mid-graph EP test's counterpart, held against JAX, is in
tests/test_torch_complex_channels.py.
"""
import numpy as np
import pytest
import torch

from tramp_tpu_torch.channels import ModulusChannel

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from test_modulus_channel import CASES, grid_oracle

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


@pytest.mark.parametrize("az,bzr,bzi,ax,bx", CASES)
def test_modulus_channel_posterior_vs_grid_oracle(az, bzr, bzi, ax, bx):
    ch = ModulusChannel(isotropic=False)
    bz, bxa = _t([[bzr], [bzi]]), _t([bx])
    rz, vz = ch.compute_backward_posterior(_t(az), bz, _t(ax), bxa)
    rx, vx = ch.compute_forward_posterior(_t(az), bz, _t(ax), bxa)
    logZ = ch.compute_log_partition(_t(az), bz, _t(ax), bxa)
    o = grid_oracle(az, bzr, bzi, ax, bx)
    atol = 2e-6
    np.testing.assert_allclose(float(rz[0, 0]), o["rzr"], atol=atol)
    np.testing.assert_allclose(float(rz[1, 0]), o["rzi"], atol=atol)
    np.testing.assert_allclose(float(vz[0]), o["vz"], atol=atol)
    np.testing.assert_allclose(float(rx[0]), o["rx"], atol=atol)
    np.testing.assert_allclose(float(vx[0]), o["vx"], atol=atol)
    np.testing.assert_allclose(float(logZ), o["logZ"], rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("az,bzr,bzi,ax,bx", CASES[:3])
def test_modulus_channel_moments_are_log_partition_gradients(
        az, bzr, bzi, ax, bx):
    "rz = dA/dbz, rx = dA/dbx, vx = d2A/dbx2 (conjugacy of the quadrature)."
    ch = ModulusChannel(isotropic=False)
    bz = _t([[bzr], [bzi]]).requires_grad_()
    bxa = _t([bx]).requires_grad_()
    A = ch.compute_log_partition(_t(az), bz, _t(ax), bxa)
    g_bz, g_bx = torch.autograd.grad(A, (bz, bxa), create_graph=True)
    h_bx = torch.autograd.grad(g_bx.sum(), bxa)[0]
    rz, _ = ch.compute_backward_posterior(_t(az), bz.detach(), _t(ax),
                                          bxa.detach())
    rx, vx = ch.compute_forward_posterior(_t(az), bz.detach(), _t(ax),
                                          bxa.detach())
    np.testing.assert_allclose(g_bz.detach().numpy(), rz.numpy(), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(g_bx.detach().numpy(), rx.numpy(), rtol=1e-6)
    np.testing.assert_allclose(h_bx.numpy(), vx.numpy(), rtol=1e-5)


def test_modulus_channel_beliefs_measure_normalized():
    ch = ModulusChannel()
    for az, ax, tau_z in [(2.0, 1.0, 0.7), (5.0, 0.1, 0.7), (1.2, 0.5, 0.7)]:
        mu = ch.beliefs_measure(_t(az), _t(ax), _t(tau_z),
                                f=lambda bz, bx: torch.ones_like(bx))
        np.testing.assert_allclose(float(mu), 1.0, rtol=1e-6)


@pytest.mark.parametrize("az,ax", [(2.0, 1.0), (3.0, 3.0), (5.0, 0.1)])
def test_modulus_channel_se_error_vs_monte_carlo(az, ax):
    """Nishimori: SE backward/forward error == BO-ensemble average of the
    posterior variance == ensemble MSE of the posterior mean."""
    tau_z = 0.7
    ch = ModulusChannel(isotropic=False)
    rng = np.random.RandomState(0)
    n = 100_000
    mz_hat = az - 1.0 / tau_z
    zs = rng.randn(2, n) * np.sqrt(tau_z)
    bz = mz_hat * zs + np.sqrt(mz_hat) * rng.randn(2, n)
    xs = np.hypot(zs[0], zs[1])
    bx = ax * xs + np.sqrt(ax) * rng.randn(n)
    rz, vz = ch.compute_backward_posterior(_t(az), _t(bz), _t(ax), _t(bx))
    rx, vx = ch.compute_forward_posterior(_t(az), _t(bz), _t(ax), _t(bx))
    se_bwd = float(ch.compute_backward_error(_t(az), _t(ax), _t(tau_z)))
    se_fwd = float(ch.compute_forward_error(_t(az), _t(ax), _t(tau_z)))
    np.testing.assert_allclose(se_bwd, float(vz.mean()), rtol=2e-2)
    np.testing.assert_allclose(se_fwd, float(vx.mean()), rtol=2e-2)
    np.testing.assert_allclose(
        se_bwd, float(((_t(zs) - rz) ** 2).mean()), rtol=2e-2)
    np.testing.assert_allclose(
        se_fwd, float(((_t(xs) - rx) ** 2).mean()), rtol=2e-2)


def test_modulus_channel_mutual_information_zero_at_no_information():
    ch = ModulusChannel()
    tau_z = _t(0.7)
    I0_ = float(ch.compute_mutual_information(1.0 / tau_z, _t(0.0), tau_z))
    np.testing.assert_allclose(I0_, 0.0, atol=1e-6)
    I1 = float(ch.compute_mutual_information(_t(2.0), _t(1.0), tau_z))
    I2 = float(ch.compute_mutual_information(_t(3.0), _t(2.0), tau_z))
    assert I1 > 0.01 and I2 > I1
