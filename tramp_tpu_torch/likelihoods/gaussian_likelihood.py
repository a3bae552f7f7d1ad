"""Gaussian likelihood. Counterpart of
tramp_tpu/likelihoods/gaussian_likelihood.py."""
import math

import torch

from .base_likelihood import Likelihood
from ..beliefs import normal
from ..config import as_tensor
from ..lanes import lane_mean, log, sqrt
from ..utils.integration import gaussian_measure, gaussian_measure_2d_full


class GaussianLikelihood(Likelihood):

    _data_fields = ("y", "var")
    _meta_fields = ("y_name", "isotropic")

    def __init__(self, y, var=1.0, y_name="y", isotropic=True, device=None,
                 dtype=None):
        super().__init__()
        self.y_name = y_name
        self.var = var
        self.isotropic = isotropic
        self.register_buffer(
            "y", None if y is None else as_tensor(y, device, dtype))

    def math(self):
        return r"$\mathcal{N}$"

    @property
    def a(self):
        return 1.0 / self.var

    @property
    def b(self):
        return None if self.y is None else self.y / self.var

    def sample(self, generator, X):
        noise = torch.randn(X.shape, generator=generator, device=X.device,
                            dtype=X.dtype)
        return X + sqrt(self.var) * noise

    def compute_backward_posterior(self, az, bz, y):
        a = az + self.a
        b = bz + self.a * y
        return b / a, 1.0 / a

    def compute_backward_message(self, az, bz):
        "Fast path: constant message. Reference l:68-71."
        return self.a * torch.ones_like(az), self.b

    def constant_backward_message(self):
        """The backward message as a model constant (a = 1/var, b = y/var),
        which the chain solver pins; None without an observation. With one
        observation per lane, ``b`` is ``(B, M)`` and ``a`` stays the one
        number all lanes share."""
        if self.y is None:
            return None
        return {"a": torch.as_tensor(self.a, dtype=self.y.dtype,
                                     device=self.y.device), "b": self.b}

    # -- SE ----------------------------------------------------------------
    def scalar_backward_mean(self, az, bz, y):
        return (bz + self.a * y) / (az + self.a)

    def scalar_backward_variance(self, az, bz, y):
        return 1.0 / (az + self.a)

    def scalar_log_partition(self, az, bz, y):
        ay = torch.as_tensor(self.a, dtype=bz.dtype, device=bz.device)
        by = ay * y
        return normal.A(az + ay, bz + by) - normal.A(ay, by)

    def compute_log_partition(self, az, bz, y):
        return lane_mean(self.scalar_log_partition(az, bz, y), az)

    def compute_backward_error(self, az, tau_z):
        return 1.0 / (az + self.a)

    def compute_backward_v_BO(self, az, tz0_hat):
        return 1.0 / (az + self.a)

    def compute_backward_state_evolution(self, az, tau_z):
        return self.a * torch.ones_like(az)

    def compute_backward_state_evolution_BO(self, az, tau_z):
        return self.a * torch.ones_like(az)

    def _teacher_cov(self, mz_hat, qz_hat, tz0_hat):
        tz0 = 1.0 / tz0_hat
        return ((qz_hat + mz_hat**2 * tz0, mz_hat * tz0),
                (mz_hat * tz0, self.var + tz0))

    def b_measure(self, mz_hat, qz_hat, tz0_hat, f):
        cov = self._teacher_cov(mz_hat, qz_hat, tz0_hat)
        return gaussian_measure_2d_full((0.0, 0.0), cov, f)

    def bz_measure(self, mz_hat, qz_hat, tz0_hat, f):
        az_star = mz_hat**2 / qz_hat + tz0_hat
        ay = self.a

        def r_times_f(bz, y):
            bz_star = (mz_hat / qz_hat) * bz
            r = (self.a * y + bz_star) / (ay + az_star)
            return r * f(bz, y)

        cov = self._teacher_cov(mz_hat, qz_hat, tz0_hat)
        return gaussian_measure_2d_full((0.0, 0.0), cov, r_times_f)

    def beliefs_measure(self, az, tau_z, f):
        u_eff = torch.clamp(az * tau_z - 1.0, min=0.0)
        cov = ((u_eff * az + 1e-12, u_eff), (u_eff, self.var + tau_z))
        return gaussian_measure_2d_full((0.0, 0.0), cov, f)

    def measure(self, y, f):
        return gaussian_measure(y, sqrt(self.var), f)

    def compute_mutual_information(self, az, tau_z):
        I = 0.5 * torch.log((az + self.a) * tau_z)
        N = 0.5 * log(2 * math.pi * math.e * self.var)
        return I + N

    def compute_free_energy(self, az, tau_z):
        a = az + self.a
        return 0.5 * az * tau_z - 1.0 - 0.5 * torch.log(a * self.var)
