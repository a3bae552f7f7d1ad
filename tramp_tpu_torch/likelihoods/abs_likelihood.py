"""Absolute-value likelihood y = |z|. Counterpart of
tramp_tpu/likelihoods/abs_likelihood.py."""
import torch

from .base_likelihood import Likelihood
from ..beliefs import binary
from ..config import as_tensor
from ..lanes import lane_mean
from ..utils.integration import (
    gaussian_measure_boundary, inner_gaussian_measure, sqrt_like)


def _measure_2d_zlayer(sz, mz_hat, q_hat, g):
    """E over z ~ N(0, sz^2), xi ~ N(0,1) of g(mz_hat z + sqrt(q_hat) xi, z)
    with quadrature panels around the z = 0 sign-ambiguity layer.

    The +-z posterior mixing factor transitions over |z| ~ sqrt(q_hat)/mz_hat
    (bz*y ~ mz_hat z^2 + sqrt(q_hat) z xi of order 1): at large precision a
    vanishing layer that a fixed global rule integrates to zero, losing the
    az^{-3/2} informative correction of the SE recovery cascade. The inner
    rule in xi runs at every node of the outer one in z."""
    def integrand(z):
        return inner_gaussian_measure(mz_hat * z, torch.sqrt(q_hat), g, z)

    d = 10.0 * (torch.sqrt(q_hat) + 1.0) / mz_hat
    points = torch.cat([torch.atleast_1d(-d), torch.atleast_1d(d)], -1)
    return gaussian_measure_boundary(0.0, sz, points, integrand)


class AbsLikelihood(Likelihood):
    """``y`` is a buffer on ``device`` with ``dtype`` (None: those of a
    tensor ``y``, else the defaults of tramp_tpu_torch.config); with lanes,
    ``(B, M)``."""

    _data_fields = ("y",)
    _meta_fields = ("y_name", "isotropic")

    def __init__(self, y, y_name="y", isotropic=True, device=None,
                 dtype=None):
        super().__init__()
        self.y_name = y_name
        self.isotropic = isotropic
        self.register_buffer(
            "y", None if y is None else as_tensor(y, device, dtype))

    def math(self):
        return r"$\mathrm{abs}$"

    def sample(self, generator, X):
        return torch.abs(X)

    def scalar_backward_mean(self, az, bz, y):
        return y * binary.r(bz * y)

    def scalar_backward_variance(self, az, bz, y):
        return y**2 * binary.v(bz * y)

    def scalar_log_partition(self, az, bz, y):
        return -0.5 * az * y**2 + binary.A(bz * y)

    def compute_backward_posterior(self, az, bz, y):
        rz = y * binary.r(bz * y)
        vz = y**2 * binary.v(bz * y)
        if self.isotropic:
            vz = lane_mean(vz, az)
        return rz, vz

    def compute_log_partition(self, az, bz, y):
        return lane_mean(self.scalar_log_partition(az, bz, y), az)

    def b_measure(self, mz_hat, qz_hat, tz0_hat, f):
        return _measure_2d_zlayer(
            sqrt_like(1.0 / tz0_hat, mz_hat), mz_hat, qz_hat,
            lambda bz, z: f(bz, torch.abs(z)))

    def bz_measure(self, mz_hat, qz_hat, tz0_hat, f):
        return _measure_2d_zlayer(
            sqrt_like(1.0 / tz0_hat, mz_hat), mz_hat, qz_hat,
            lambda bz, z: z * f(bz, torch.abs(z)))

    def beliefs_measure(self, az, tau_z, f):
        # floor at AMIN: the reference asserts az > 1/tau_z strictly
        # (sgn_likelihood.py:81); at the uninformed point az == 1/tau_z
        # the measure degenerates, and a tiny positive floor keeps it
        # defined while preserving the instability of that fixed point
        mz_hat = torch.clamp(az - 1.0 / tau_z, min=1e-11)
        return _measure_2d_zlayer(
            sqrt_like(tau_z, mz_hat), mz_hat, mz_hat,
            lambda bz, z: f(bz, torch.abs(z)))

    def measure(self, y, f):
        return f(+y) + f(-y)
