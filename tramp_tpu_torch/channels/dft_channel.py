"""Unitary DFT channel x = FFT z (orthonormal): its messages are FFTs.
Counterpart of tramp_tpu/channels/dft_channel.py, on ``torch.fft``
(conv_channel.py says why).

The output x is packed re/im, ``(2,) + shape``, for a real z and a complex
z alike, as in the JAX package (a complex z travels packed too). With lanes
the packed axis follows the lane axis, ``(B, 2) + shape``, and the FFT runs
over the trailing axes of the field only; a precision passed from one side
to the other takes the axes of the other side's message."""
import math

import torch

from .base_channel import Channel
from ..lanes import lane_count, lane_sum, like
from ..utils.misc import pack, unpack


class DFTChannel(Channel):
    "Reference dft_channel.py:17-80."

    _data_fields = ()
    _meta_fields = ("real",)

    def __init__(self, real=True):
        super().__init__()
        self.real = real

    def math(self):
        return r"$\mathcal{F}$"

    def out_shape(self, shape):
        return (2,) + tuple(shape) if self.real else tuple(shape)

    @staticmethod
    def _fft(c, lanes, inverse=False):
        "Orthonormal FFT of a complex field over all its axes but the lanes."
        dims = tuple(range(1 if lanes else 0, c.ndim))
        return (torch.fft.ifftn if inverse else torch.fft.fftn)(
            c, dim=dims, norm="ortho")

    def sample(self, generator, Z):
        if not self.real:
            Z = unpack(Z)
        return pack(self._fft(Z, False))

    def second_moment(self, tau_z):
        return tau_z

    def compute_forward_message(self, az, bz, ax, bx):
        lanes = lane_count(az, bz) is not None
        axis = 1 if lanes else 0
        c = bz if self.real else unpack(bz, axis)
        return like(az, ax), pack(self._fft(c, lanes), axis)

    def compute_backward_message(self, az, bz, ax, bx):
        lanes = lane_count(ax, bx) is not None
        axis = 1 if lanes else 0
        c = self._fft(unpack(bx, axis), lanes, inverse=True)
        return like(ax, az), (c.real if self.real else pack(c, axis))

    def compute_forward_state_evolution(self, az, ax, tau_z):
        return az

    def compute_backward_state_evolution(self, az, ax, tau_z):
        return ax

    def compute_log_partition(self, az, bz, ax, bx):
        lanes = lane_count(az, bz) is not None
        _, bz_new = self.compute_backward_message(az, bz, ax, bx)
        b = bz + bz_new
        a = az + like(ax, az)
        coef = 0.5 if self.real else 1.0
        n = b[0].numel() if lanes else b.numel()
        n = n if self.real else n / 2
        log_term = coef * n * torch.log(2 * math.pi / a)
        return (0.5 * lane_sum(b**2 / a, lanes)
                + (log_term.reshape(-1) if lanes else log_term))

    def compute_mutual_information(self, az, ax, tau_z):
        return 0.5 * torch.log((ax + az) * tau_z)

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + ax * tau_x) - I
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))
