"""Additive Gaussian noise channel x = z + xi.
Counterpart of tramp_tpu/channels/gaussian_channel.py."""
import math

import torch

from .base_channel import Channel
from ..lanes import lane_count, per_lane, sqrt


class GaussianChannel(Channel):

    _data_fields = ("var",)
    _meta_fields = ()

    def __init__(self, var=1.0):
        super().__init__()
        self.var = var

    def math(self):
        return r"$\mathcal{N}$"

    @property
    def a(self):
        return 1.0 / self.var

    def sample(self, generator, Z):
        noise = torch.randn(Z.shape, generator=generator, device=Z.device,
                            dtype=Z.dtype)
        return Z + sqrt(self.var) * noise

    def second_moment(self, tau_z):
        return tau_z + self.var

    def compute_forward_state_evolution(self, az, ax, tau_z):
        kz = self.a / (self.a + az)
        return kz * az

    def compute_backward_state_evolution(self, az, ax, tau_z):
        kx = self.a / (self.a + ax)
        return kx * ax

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

    def compute_log_partition(self, az, bz, ax, bx):
        az_new, bz_new = self.compute_backward_message(az, bz, ax, bx)
        rz = (bz_new + bz) / (az_new + az)
        ax_new, bx_new = self.compute_forward_message(az, bz, ax, bx)
        rx = (bx_new + bx) / (ax_new + ax)
        d = ax + az + ax * az * self.var
        terms = rz * bz + rx * bx + torch.log(2 * math.pi / d)
        lanes = lane_count(az, bz) is not None
        return 0.5 * (per_lane(terms, True).sum(-1) if lanes
                      else torch.sum(terms))

    def compute_mutual_information(self, az, ax, tau_z):
        a = ax + az + ax * az / self.a
        return 0.5 * torch.log(a * tau_z)

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + ax * tau_x) - I
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))
