"""Gauss-Bernoulli (spike-and-slab) prior. Counterpart of
tramp_tpu/priors/gauss_bernoulli_prior.py:11-75 (EP part)."""
import math

import torch

from .base_prior import Prior
from ..beliefs import normal, sparse
from ..config import default_device, DEFAULT_DTYPE
from ..lanes import lane_mean


class GaussBernoulliPrior(Prior):
    r"""$p(x)=[1-\rho]\,\delta(x)+\rho\,\mathcal{N}(x|mean, var)$.
    Reference gauss_bernoulli_prior.py:8-126.

    ``device`` and ``dtype`` are those of the samples it draws (None: the
    defaults of tramp_tpu_torch.config)."""

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

    @property
    def a(self):
        return 1.0 / self.var

    @property
    def b(self):
        return self.mean / self.var

    @property
    def eta(self):
        # eta = A(a,b) - log(rho/(1-rho)), reference l:36, in float64
        a, b = (torch.tensor(v, dtype=torch.float64) for v in (self.a, self.b))
        return normal.A(a, b).item() - math.log(self.rho / (1.0 - self.rho))

    def _shape(self):
        return self.size if isinstance(self.size, tuple) else (self.size,)

    def out_shape(self):
        return self._shape()

    def sample(self, generator):
        shape = self._shape()
        kw = dict(generator=generator,
                  device=self.device or default_device(),
                  dtype=self.dtype or DEFAULT_DTYPE)
        x_gauss = self.mean + math.sqrt(self.var) * torch.randn(shape, **kw)
        x_bern = torch.rand(shape, **kw) < self.rho
        return x_gauss * x_bern

    def compute_forward_posterior(self, ax, bx):
        a = ax + self.a
        b = bx + self.b
        eta = self.eta
        rx = sparse.r(a, b, eta)
        vx = sparse.v(a, b, eta)
        if self.isotropic:
            vx = lane_mean(vx, ax)
        return rx, vx
