"""Sign likelihood y = sgn(z). Counterpart of
tramp_tpu/likelihoods/sgn_likelihood.py."""
import torch

from .base_likelihood import Likelihood
from ..beliefs import positive
from ..config import as_tensor
from ..lanes import lane_mean
from ..utils.integration import gaussian_measure


class SgnLikelihood(Likelihood):
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
        return r"$\mathrm{sgn}$"

    def sample(self, generator, X):
        return torch.sign(X)

    def scalar_backward_mean(self, az, bz, y):
        return y * positive.r(az, bz * y)

    def scalar_backward_variance(self, az, bz, y):
        return positive.v(az, bz * y)

    def scalar_log_partition(self, az, bz, y):
        return positive.A(az, bz * y)

    def compute_backward_posterior(self, az, bz, y):
        rz = y * positive.r(az, bz * y)
        vz = positive.v(az, bz * y)
        if self.isotropic:
            vz = lane_mean(vz, az)
        return rz, vz

    def compute_log_partition(self, az, bz, y):
        return lane_mean(positive.A(az, bz * y), az)

    def b_measure(self, mz_hat, qz_hat, tz0_hat, f):
        az_star = mz_hat**2 / qz_hat + tz0_hat

        def f_pos(bz):
            p = positive.p(az_star, +(mz_hat / qz_hat) * bz)
            return p * f(bz, +1.0)

        def f_neg(bz):
            p = positive.p(az_star, -(mz_hat / qz_hat) * bz)
            return p * f(bz, -1.0)

        tz0 = 1.0 / tz0_hat
        sz_eff = torch.sqrt(qz_hat + mz_hat**2 * tz0)
        return (gaussian_measure(0.0, sz_eff, f_pos)
                + gaussian_measure(0.0, sz_eff, f_neg))

    def bz_measure(self, mz_hat, qz_hat, tz0_hat, f):
        az_star = mz_hat**2 / qz_hat + tz0_hat

        def f_pos(bz):
            bz_star = (mz_hat / qz_hat) * bz
            return (positive.p(az_star, +bz_star)
                    * positive.r(az_star, +bz_star) * f(bz, +1.0))

        def f_neg(bz):
            bz_star = (mz_hat / qz_hat) * bz
            return (positive.p(az_star, -bz_star)
                    * -positive.r(az_star, -bz_star) * f(bz, -1.0))

        tz0 = 1.0 / tz0_hat
        sz_eff = torch.sqrt(qz_hat + mz_hat**2 * tz0)
        return (gaussian_measure(0.0, sz_eff, f_pos)
                + gaussian_measure(0.0, sz_eff, f_neg))

    def beliefs_measure(self, az, tau_z, f):
        # floor at AMIN: the reference asserts az > 1/tau_z strictly
        # (sgn_likelihood.py:81); at the uninformed point az == 1/tau_z
        # the measure degenerates, and a tiny positive floor keeps it
        # defined while preserving the instability of that fixed point
        mz_hat = torch.clamp(az - 1.0 / tau_z, min=1e-11)

        def f_pos(bz):
            return positive.p(az, +bz) * f(bz, +1.0)

        def f_neg(bz):
            return positive.p(az, -bz) * f(bz, -1.0)

        sz_eff = torch.sqrt(mz_hat + mz_hat**2 * tau_z)
        return (gaussian_measure(0.0, sz_eff, f_pos)
                + gaussian_measure(0.0, sz_eff, f_neg))
