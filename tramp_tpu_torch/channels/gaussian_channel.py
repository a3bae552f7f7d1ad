"""Additive Gaussian noise channel x = z + xi.
Counterpart of tramp_tpu/channels/gaussian_channel.py (EP part)."""
import math

import torch

from .base_channel import Channel


class GaussianChannel(Channel):

    _data_fields = ("var",)
    _meta_fields = ()

    def __init__(self, var=1.0):
        super().__init__()
        self.var = var

    @property
    def a(self):
        return 1.0 / self.var

    def sample(self, generator, Z):
        noise = torch.randn(Z.shape, generator=generator, device=Z.device,
                            dtype=Z.dtype)
        return Z + math.sqrt(self.var) * noise

    def compute_forward_message(self, az, bz, ax, bx):
        "Closed-form rescale k = a/(a+az). Reference l:23-27."
        kz = self.a / (self.a + az)
        return kz * az, kz * bz

    def compute_backward_message(self, az, bz, ax, bx):
        kx = self.a / (self.a + ax)
        return kx * ax, kx * bx

    def compute_forward_posterior(self, az, bz, ax, bx):
        # posterior on x given both sides: precision ax + a*az/(a+az)
        k = self.a / (self.a + az)
        a_eff = ax + k * az
        b_eff = bx + k * bz
        return b_eff / a_eff, 1.0 / a_eff

    def compute_backward_posterior(self, az, bz, ax, bx):
        k = self.a / (self.a + ax)
        a_eff = az + k * ax
        b_eff = bz + k * bx
        return b_eff / a_eff, 1.0 / a_eff
