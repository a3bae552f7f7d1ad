"""Gauss-Bernoulli (spike-and-slab) prior. Counterpart of
tramp_tpu/priors/gauss_bernoulli_prior.py."""
import math

import torch

from .base_prior import Prior
from ..beliefs import sparse
from ..config import default_device, DEFAULT_DTYPE
from ..lanes import lane_mean, log, sqrt
from ..ops import gb_prior
from ..utils.integration import gaussian_measure, gaussian_measure_boundary


class GaussBernoulliPrior(Prior):
    r"""$p(x)=[1-\rho]\,\delta(x)+\rho\,\mathcal{N}(x|mean, var)$.
    Reference gauss_bernoulli_prior.py:8-126.

    ``device`` and ``dtype`` are those of the samples it draws (None: the
    defaults of tramp_tpu_torch.config). ``rho``, ``mean`` and ``var`` are
    Python numbers, or one value per lane as tensors ``(B, 1)``
    (``lanes.stack_models``)."""

    _data_fields = ("rho", "mean", "var")
    _meta_fields = ("size", "isotropic")
    device = None
    dtype = None

    def __init__(self, size, rho=0.5, mean=0.0, var=1.0, isotropic=True,
                 device=None, dtype=None):
        super().__init__()
        self.size = size
        self.rho = rho
        self.mean = mean
        self.var = var
        self.isotropic = isotropic
        self.device = device
        self.dtype = dtype

    def math(self):
        return r"$\mathcal{N}_\rho$"

    @property
    def a(self):
        return 1.0 / self.var

    @property
    def b(self):
        return self.mean / self.var

    @property
    def eta(self):
        """eta = A(a, b) - log(rho / (1 - rho)), reference l:36: a Python
        float from Python numbers (no tensor is built and no device is
        read), a tensor per lane from per-lane hyperparameters."""
        a, b = self.a, self.b
        return (0.5 * (b**2 / a + log(2.0 * math.pi / a))
                - log(self.rho / (1.0 - self.rho)))

    def _shape(self):
        return self.size if isinstance(self.size, tuple) else (self.size,)

    def out_shape(self):
        return self._shape()

    def sample(self, generator):
        shape = self._shape()
        kw = dict(generator=generator,
                  device=self.device or default_device(),
                  dtype=self.dtype or DEFAULT_DTYPE)
        x_gauss = self.mean + sqrt(self.var) * torch.randn(shape, **kw)
        x_bern = torch.rand(shape, **kw) < self.rho
        return x_gauss * x_bern

    # The isotropic posterior and message are ops/gb_prior.py's: its laned
    # kernel wherever the kernel takes the inputs (``gb_prior.takes``:
    # precisions 0-d or per lane, hyperparameters of bx's type), else, and
    # off the card, its plain version, the eager chain bit for bit. Only a
    # prior with per-element variances keeps the chain here.
    def compute_forward_posterior(self, ax, bx):
        hyper = (self.a, self.b, self.eta)
        if self.isotropic:
            if gb_prior.takes(ax, bx, *hyper):
                return gb_prior.gb_posterior(ax, bx, *hyper)
            return gb_prior.gb_posterior_plain(ax, bx, *hyper)
        a = ax + self.a
        b = bx + self.b
        return sparse.r(a, b, self.eta), sparse.v(a, b, self.eta)

    def compute_forward_message(self, ax, bx):
        hyper = (self.a, self.b, self.eta)
        if self.isotropic and gb_prior.takes(ax, bx, *hyper):
            return gb_prior.gb_message(ax, bx, *hyper)
        return super().compute_forward_message(ax, bx)

    def second_moment(self):
        return self.rho * (self.mean**2 + self.var)

    def forward_second_moment_FG(self, tx_hat):
        return sparse.tau(tx_hat + self.a, self.b, self.eta)

    def scalar_forward_mean(self, ax, bx):
        return sparse.r(ax + self.a, bx + self.b, self.eta)

    def scalar_forward_variance(self, ax, bx):
        return sparse.v(ax + self.a, bx + self.b, self.eta)

    def scalar_log_partition(self, ax, bx):
        a, b, eta = self.a, self.b, self.eta
        at, bt = (torch.as_tensor(v, dtype=bx.dtype, device=bx.device)
                  for v in (a, b))
        return sparse.A(ax + a, bx + b, eta) - sparse.A(at, bt, eta)

    def compute_log_partition(self, ax, bx):
        return lane_mean(self.scalar_log_partition(ax, bx), ax)

    def _slab(self, tx0_hat):
        "(a0, r0, v0, rho) of the slab tilted by a teacher precision."
        a0 = self.a + tx0_hat
        return a0, self.b / a0, 1.0 / a0, sparse.p(
            a0, torch.as_tensor(self.b, dtype=a0.dtype, device=a0.device),
            self.eta)

    def b_measure(self, mx_hat, qx_hat, tx0_hat, f):
        _, r0, v0, rho = self._slab(tx0_hat)
        mu_0 = gaussian_measure(0.0, torch.sqrt(qx_hat), f)
        mu_1 = gaussian_measure(
            mx_hat * r0, torch.sqrt(qx_hat + mx_hat**2 * v0), f)
        return (1.0 - rho) * mu_0 + rho * mu_1

    def bx_measure(self, mx_hat, qx_hat, tx0_hat, f):
        a0, r0, v0, rho = self._slab(tx0_hat)
        ax_star = mx_hat**2 / qx_hat

        def r_times_f(bx):
            bx_star = (mx_hat / qx_hat) * bx
            return (self.b + bx_star) / (a0 + ax_star) * f(bx)

        mu_1 = gaussian_measure(
            mx_hat * r0, torch.sqrt(qx_hat + mx_hat**2 * v0), r_times_f)
        return rho * mu_1

    def beliefs_measure(self, ax, f):
        # spike<->slab transition layer: the posterior slab probability
        # expit(normal.A(ax + a, bx + b) - eta) switches at
        # |bx + b| = b* = sqrt(2 a_eff (eta + log(a_eff/2pi)/2)), a layer of
        # width ~a_eff/b*, a vanishing fraction of the measure's scale ~ax
        # at large ax (cf. utils.integration.gaussian_measure_boundary)
        a_eff = ax + self.a
        arg = 2.0 * a_eff * (self.eta
                             + 0.5 * torch.log(a_eff / (2 * math.pi)))
        b_star = torch.sqrt(torch.clamp(arg, min=0.0))
        w = 10.0 * a_eff / torch.clamp(b_star, min=1.0)
        pts = torch.cat([
            torch.atleast_1d(p) for p in
            (-b_star - self.b - w, -b_star - self.b + w,
             b_star - self.b - w, b_star - self.b + w)], -1)
        mu_0 = gaussian_measure_boundary(0.0, torch.sqrt(ax), pts, f)
        mu_1 = gaussian_measure_boundary(
            ax * self.mean, torch.sqrt(ax + ax**2 * self.var), pts, f)
        return (1.0 - self.rho) * mu_0 + self.rho * mu_1

    def measure(self, f):
        mean = torch.as_tensor(self.mean, dtype=torch.float64,
                               device=self.device or default_device())
        g = gaussian_measure(mean, sqrt(self.var), f)
        return (1.0 - self.rho) * f(torch.zeros_like(mean)) + self.rho * g
