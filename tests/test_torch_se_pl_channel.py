"""The state-evolution methods of the piecewise-linear channels,
tramp_tpu_torch against tramp_tpu, float64 on the CPU: second moment, errors,
SE updates, free energy, mutual information, overlaps and
``beliefs_measure`` of relu, leaky relu, abs, hard tanh and door (two and
three regions, slope 0 and not), over a grid of (az, ax, tau_z) that includes
ax = 0 and az * tau_z = 1 (the degenerate covariances of the measure).

On the CPU the integrands are outputs of ``pl_posterior_plain``; the JAX
package evaluates them region by region. Tolerance: rtol 1e-9
(torch_parity.assert_close: quadrature sums of 10^4 nodes per region in
another order, a 2 x 2 Cholesky written out); lanes against the same methods
called lane by lane, in the port: 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu import channels as jchannels

from tramp_tpu_torch import channels

from torch_parity import assert_close

F64 = torch.float64
RTOL = 1e-9
# (az, ax, tau_z): generic, ax = 0, az * tau_z = 1, large precisions
GRID = [(1.7, 0.9, 1.2), (0.8, 0.0, 2.0), (2.0, 0.6, 0.5), (25.0, 40.0, 0.3)]


def _t(x):
    return torch.as_tensor(x, dtype=F64)


def _col(values):
    return torch.as_tensor(np.asarray(values), dtype=F64).reshape(-1, 1)


PL = {
    "relu": (channels.ReluChannel, jchannels.ReluChannel, {}),
    "l-relu": (channels.LeakyReluChannel, jchannels.LeakyReluChannel,
               dict(slope=0.3)),
    "abs": (channels.AbsChannel, jchannels.AbsChannel, {}),
    "h-tanh": (channels.HardTanhChannel, jchannels.HardTanhChannel, {}),
    "door": (channels.SymmetricDoorChannel, jchannels.SymmetricDoorChannel,
             dict(width=0.7)),
}


def _pl_pair(name):
    cls, jcls, kw = PL[name]
    return cls(**kw), jcls(**kw)


# every grid point for a channel of two regions and one of three, the
# degenerate ones for the others
PL_CASES = [(name, i) for name, points in (
    ("relu", (0, 1, 2, 3)), ("h-tanh", (0, 1, 2, 3)), ("l-relu", (0, 1, 2)),
    ("abs", (1, 2)), ("door", (1,))) for i in points]


@pytest.mark.parametrize("name,point", PL_CASES)
def test_piecewise_linear_se_methods(name, point):
    port, ref = _pl_pair(name)
    az, ax, tau_z = GRID[point]
    for method in ("compute_forward_error", "compute_backward_error",
                   "compute_free_energy"):
        assert_close(getattr(port, method)(_t(az), _t(ax), _t(tau_z)),
                     getattr(ref, method)(az, ax, tau_z), RTOL, what=method)
    assert_close(port.second_moment(_t(tau_z)), ref.second_moment(tau_z),
                 RTOL)


@pytest.mark.parametrize("name", ["relu", "l-relu", "h-tanh"])
def test_piecewise_linear_se_updates_and_information(name):
    port, ref = _pl_pair(name)
    az, ax, tau_z = GRID[0]
    for method in ("compute_forward_state_evolution",
                   "compute_backward_state_evolution",
                   "compute_mutual_information", "compute_forward_overlap",
                   "compute_backward_overlap"):
        assert_close(getattr(port, method)(_t(az), _t(ax), _t(tau_z)),
                     getattr(ref, method)(az, ax, tau_z), RTOL, what=method)
    assert_close(port.beliefs_measure(_t(az), _t(ax), _t(tau_z),
                                      lambda bz, bx: torch.tanh(bz) + bx**2),
                 ref.beliefs_measure(az, ax, tau_z,
                                     lambda bz, bx: jnp.tanh(bz) + bx**2), RTOL)
    # region by region, the reference's form, equals the one-call form
    by_region = sum(
        rg.beliefs_measure(_t(az), _t(ax), _t(tau_z),
                           lambda bz, bx: torch.tanh(bz) + bx**2)
        for rg in port.regions)
    assert_close(by_region, ref.beliefs_measure(
        az, ax, tau_z, lambda bz, bx: jnp.tanh(bz) + bx**2), RTOL)


@pytest.mark.parametrize("name,methods", [
    ("relu", ("compute_forward_error", "compute_backward_error",
              "compute_free_energy")),
    ("h-tanh", ("compute_backward_error",))])
def test_piecewise_linear_lanes(name, methods):
    "(B, 1) precisions: every lane equals the call on that lane's numbers."
    port, _ = _pl_pair(name)
    az, ax, tau = zip(*GRID[:3])
    for method in methods:
        got = getattr(port, method)(_col(az), _col(ax), _col(tau))
        want = [float(getattr(port, method)(_t(a), _t(x), _t(t)))
                for a, x, t in zip(az, ax, tau)]
        assert got.shape == (3, 1)
        assert_close(got, np.reshape(want, (3, 1)), 1e-12, what=method)
