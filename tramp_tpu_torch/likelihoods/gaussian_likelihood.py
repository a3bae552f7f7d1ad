"""Gaussian likelihood. Counterpart of
tramp_tpu/likelihoods/gaussian_likelihood.py:10-70 (EP part)."""
import math

import torch

from .base_likelihood import Likelihood
from ..config import as_tensor


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

    @property
    def a(self):
        return 1.0 / self.var

    @property
    def b(self):
        return None if self.y is None else self.y / self.var

    def sample(self, generator, X):
        noise = torch.randn(X.shape, generator=generator, device=X.device,
                            dtype=X.dtype)
        return X + math.sqrt(self.var) * noise

    def compute_backward_posterior(self, az, bz, y):
        a = az + self.a
        b = bz + self.a * y
        return b / a, 1.0 / a

    def compute_backward_message(self, az, bz):
        "Fast path: constant message. Reference l:68-71."
        return self.a * torch.ones_like(az), self.b
