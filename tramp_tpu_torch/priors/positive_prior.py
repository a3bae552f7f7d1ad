"""Positive (half-normal) prior. Counterpart of
tramp_tpu/priors/positive_prior.py.

The reference leaves the SE measures NotImplemented; the JAX package
implements them in closed 1D form (x* = |g| with g ~ N(0, v0); conditioning
the Gaussian pair (g, bx) on g > 0 folds the half-normal into a smooth ncdf
weight):

  E f(bx) = 2 E_{u ~ N(0, s^2)}[ Phi(E[g|u]/sd(g|u)) f(u) ],
  s^2 = mx_hat^2 v0 + qx_hat,  E[g|u] = mx_hat sqrt(v0) u / s^2,
  Var(g|u) = qx_hat / s^2.
"""
import math

import torch

from .base_prior import Prior
from ..beliefs import positive
from ..config import default_device, DEFAULT_DTYPE
from ..lanes import lane_mean, sqrt
from ..utils.integration import gaussian_measure, truncated_gaussian_measure
from ..utils.special import norm_cdf, norm_pdf


class PositivePrior(Prior):
    r"""$p(x) = 2 \cdot 1_+(x) \mathcal{N}(x|0,1)$. Reference
    positive_prior.py:8-82. ``device`` and ``dtype`` are those of the
    samples it draws (None: the defaults of tramp_tpu_torch.config)."""

    _data_fields = ()
    _meta_fields = ("size", "isotropic")
    device = None
    dtype = None

    a = 1.0
    b = 0.0

    def __init__(self, size, isotropic=True, device=None, dtype=None):
        super().__init__()
        self.size = size
        self.isotropic = isotropic
        self.device = device
        self.dtype = dtype

    def math(self):
        return r"$\mathcal{N}_+$"

    def _shape(self):
        return self.size if isinstance(self.size, tuple) else (self.size,)

    def out_shape(self):
        return self._shape()

    def sample(self, generator):
        return torch.abs(torch.randn(
            self._shape(), generator=generator,
            device=self.device or default_device(),
            dtype=self.dtype or DEFAULT_DTYPE))

    def second_moment(self):
        return 1.0

    def forward_second_moment_FG(self, tx_hat):
        return positive.tau(tx_hat + self.a, self.b + torch.zeros_like(tx_hat))

    def scalar_forward_mean(self, ax, bx):
        return positive.r(ax + self.a, bx + self.b)

    def scalar_forward_variance(self, ax, bx):
        return positive.v(ax + self.a, bx + self.b)

    def scalar_log_partition(self, ax, bx):
        at, bt = (torch.as_tensor(v, dtype=bx.dtype, device=bx.device)
                  for v in (self.a, self.b))
        return positive.A(ax + at, bx + bt) - positive.A(at, bt)

    def compute_forward_posterior(self, ax, bx):
        a = ax + self.a
        b = bx + self.b
        rx = positive.r(a, b)
        vx = positive.v(a, b)
        if self.isotropic:
            vx = lane_mean(vx, ax)
        return rx, vx

    def compute_log_partition(self, ax, bx):
        return lane_mean(self.scalar_log_partition(ax, bx), ax)

    # -- SE measures (NotImplemented in the reference) -------------------
    def b_measure(self, mx_hat, qx_hat, tx0_hat, f):
        a0 = self.a + tx0_hat        # tilted half-normal variance v0 = 1/a0
        v0 = 1.0 / a0
        s = torch.sqrt(mx_hat**2 * v0 + qx_hat)

        def weighted(bx):
            t = mx_hat * sqrt(v0) * bx / (s * torch.sqrt(qx_hat))
            return norm_cdf(t) * f(bx)

        return 2.0 * gaussian_measure(0.0, s, weighted)

    def bx_measure(self, mx_hat, qx_hat, tx0_hat, f):
        a0 = self.a + tx0_hat
        v0 = 1.0 / a0
        sv = sqrt(v0)
        s2 = mx_hat**2 * v0 + qx_hat
        s = torch.sqrt(s2)

        def weighted(bx):
            mu_g = mx_hat * sv * bx / s2
            sg = torch.sqrt(qx_hat) / s
            t = mu_g / sg
            return sv * (mu_g * norm_cdf(t) + sg * norm_pdf(t)) * f(bx)

        return 2.0 * gaussian_measure(0.0, s, weighted)

    def beliefs_measure(self, ax, f):
        return self.b_measure(ax, ax, 0.0, f)

    def measure(self, f):
        zero = torch.zeros((), dtype=torch.float64,
                           device=self.device or default_device())
        return 2.0 * truncated_gaussian_measure(zero, 1.0, 0.0, math.inf, f)
