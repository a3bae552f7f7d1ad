"""Standalone analytic abs/relu channels via erfcx-based phi functions.
Counterpart of tramp_tpu/channels/analytic_activations.py.

Functionally equivalent alternatives to the piecewise-linear channels
(and, like the reference's tramp/channels/activation/abs_channel.py:8 and
relu_channel.py:8, not in the string registry). The posterior is a
two-branch Gaussian mixture weighted through the log-Phi derivatives
phi_0/phi_1/phi_2 (utils/special.py, reference tramp/utils/misc.py:74-86).
They have EP methods only, as in the JAX package.
"""
import torch

from .base_channel import Channel
from ..lanes import lane_mean
from ..utils.special import phi_0, phi_1, phi_2


class AnalyticAbsChannel(Channel):
    "x = |z| with closed-form two-branch posterior. Reference abs_channel.py."

    _data_fields = ()
    _meta_fields = ()

    def math(self):
        return r"$\mathrm{abs}$"

    def sample(self, generator, Z):
        return torch.abs(Z)

    def second_moment(self, tau_z):
        return tau_z

    def _branches(self, az, bz, ax, bx):
        a = ax + az
        x_pos = (bx + bz) / torch.sqrt(a)
        x_neg = (bx - bz) / torch.sqrt(a)
        delta = phi_0(x_pos) - phi_0(x_neg)
        return a, x_pos, x_neg, torch.sigmoid(delta), torch.sigmoid(-delta)

    def compute_forward_posterior(self, az, bz, ax, bx):
        a, x_pos, x_neg, s_pos, s_neg = self._branches(az, bz, ax, bx)
        r_pos = phi_1(x_pos) / torch.sqrt(a)
        r_neg = phi_1(x_neg) / torch.sqrt(a)
        v_pos = phi_2(x_pos) / a
        v_neg = phi_2(x_neg) / a
        rx = s_pos * r_pos + s_neg * r_neg
        v = s_pos * s_neg * (r_pos - r_neg) ** 2 \
            + s_pos * v_pos + s_neg * v_neg
        return rx, lane_mean(v, az, ax)

    def compute_backward_posterior(self, az, bz, ax, bx):
        a, x_pos, x_neg, s_pos, s_neg = self._branches(az, bz, ax, bx)
        r_pos = +phi_1(x_pos) / torch.sqrt(a)
        r_neg = -phi_1(x_neg) / torch.sqrt(a)
        v_pos = phi_2(x_pos) / a
        v_neg = phi_2(x_neg) / a
        rz = s_pos * r_pos + s_neg * r_neg
        v = s_pos * s_neg * (r_pos - r_neg) ** 2 \
            + s_pos * v_pos + s_neg * v_neg
        return rz, lane_mean(v, az, ax)


class AnalyticReluChannel(Channel):
    "x = relu(z), closed-form two-branch posterior. Reference relu_channel.py."

    _data_fields = ()
    _meta_fields = ()

    def math(self):
        return r"$\mathrm{relu}$"

    def sample(self, generator, Z):
        return torch.clamp(Z, min=0.0)

    def second_moment(self, tau_z):
        return 0.5 * tau_z

    def _branches(self, az, bz, ax, bx):
        a = ax + az
        x_pos = (bx + bz) / torch.sqrt(a)
        x_neg = -bz / torch.sqrt(az)
        delta = phi_0(x_pos) - phi_0(x_neg) + 0.5 * torch.log(az / a)
        return a, x_pos, x_neg, torch.sigmoid(delta), torch.sigmoid(-delta)

    def compute_forward_posterior(self, az, bz, ax, bx):
        a, x_pos, x_neg, s_pos, s_neg = self._branches(az, bz, ax, bx)
        r_pos = phi_1(x_pos) / torch.sqrt(a)
        v_pos = phi_2(x_pos) / a
        rx = s_pos * r_pos                       # negative branch: x = 0
        v = s_pos * s_neg * r_pos**2 + s_pos * v_pos
        return rx, lane_mean(v, az, ax)

    def compute_backward_posterior(self, az, bz, ax, bx):
        a, x_pos, x_neg, s_pos, s_neg = self._branches(az, bz, ax, bx)
        r_pos = +phi_1(x_pos) / torch.sqrt(a)
        r_neg = -phi_1(x_neg) / torch.sqrt(az)
        v_pos = phi_2(x_pos) / a
        v_neg = phi_2(x_neg) / az
        rz = s_pos * r_pos + s_neg * r_neg
        v = s_pos * s_neg * (r_pos - r_neg) ** 2 \
            + s_pos * v_pos + s_neg * v_neg
        return rz, lane_mean(v, az, ax)
