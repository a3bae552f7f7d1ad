"""Channel base classes. Counterpart of
tramp_tpu/channels/base_channel.py."""
import math

import torch

from ..base import Factor


class Channel(Factor):
    n_next = 1
    n_prev = 1

    # Elementwise integrands of the SE quadrature measures. Channels whose
    # posterior applies an isotropic reduction (a mean over the elements)
    # MUST override these with variants that do not reduce: the quadrature
    # evaluates f on all its nodes at once, so a reduction inside f would
    # average across quadrature nodes.
    def scalar_forward_variance(self, az, bz, ax, bx):
        rx, vx = self.compute_forward_posterior(az, bz, ax, bx)
        return vx

    def scalar_backward_variance(self, az, bz, ax, bx):
        rz, vz = self.compute_backward_posterior(az, bz, ax, bx)
        return vz

    def scalar_log_partition(self, az, bz, ax, bx):
        return self.compute_log_partition(az, bz, ax, bx)

    def compute_forward_error(self, az, ax, tau_z):
        def variance(bz, bx):
            return self.scalar_forward_variance(az, bz, ax, bx)
        return self.beliefs_measure(az, ax, tau_z, f=variance)

    def compute_backward_error(self, az, ax, tau_z):
        def variance(bz, bx):
            return self.scalar_backward_variance(az, bz, ax, bx)
        return self.beliefs_measure(az, ax, tau_z, f=variance)

    def compute_forward_overlap(self, az, ax, tau_z):
        vx = self.compute_forward_error(az, ax, tau_z)
        return self.second_moment(tau_z) - vx

    def compute_backward_overlap(self, az, ax, tau_z):
        vz = self.compute_backward_error(az, ax, tau_z)
        return tau_z - vz

    def compute_free_energy(self, az, ax, tau_z):
        def log_partition(bz, bx):
            return self.scalar_log_partition(az, bz, ax, bx)
        return self.beliefs_measure(az, ax, tau_z, f=log_partition)

    def get_alpha(self):
        return getattr(self, "alpha", 1.0)

    def compute_mutual_information(self, az, ax, tau_z):
        alpha = self.get_alpha()
        tau_x = self.second_moment(tau_z)
        A = self.compute_free_energy(az, ax, tau_z)
        return (0.5 * (az * tau_z + alpha * ax * tau_x) - A
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))

    def compute_precision(self, vz, vx, tau_z, n_steps=60):
        """Solve (backward_error, forward_error) = (vz, vx) for (az, ax) by
        damped fixed-point iteration (reference l:70-79)."""
        az, ax = 1.0 / vz, 1.0 / vx
        for _ in range(n_steps):
            vz_c = self.compute_backward_error(az, ax, tau_z)
            vx_c = self.compute_forward_error(az, ax, tau_z)
            az = torch.clamp(az + (1.0 / vz - 1.0 / vz_c) * 0.5, min=1e-11)
            ax = torch.clamp(ax + (1.0 / vx - 1.0 / vx_c) * 0.5, min=1e-11)
        return az, ax

    def compute_dual_mutual_information(self, vz, vx, tau_z):
        alpha = self.get_alpha()
        az, ax = self.compute_precision(vz, vx, tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return I - 0.5 * (az * vz + alpha * ax * vx)

    def compute_dual_free_energy(self, mz, mx, tau_z):
        alpha = self.get_alpha()
        tau_x = self.second_moment(tau_z)
        az, ax = self.compute_precision(tau_z - mz, tau_x - mx, tau_z)
        A = self.compute_free_energy(az, ax, tau_z)
        return 0.5 * (az * mz + alpha * ax * mx) - A


class SIFactor(Factor):
    """Single-input factor (multi-output). Reference base_channel.py:99-117;
    its messages and SE updates are ``Factor``'s."""
    n_prev = 1


class SOFactor(Factor):
    """Single-output factor (multi-input). Reference base_channel.py:120-136;
    its messages and SE updates are ``Factor``'s."""
    n_next = 1


class MatrixFactorization(SOFactor):
    """Two-input factor x = f(u, v) (the low-rank factorization).
    Reference base_channel.py:139-140."""
    n_prev = 2
