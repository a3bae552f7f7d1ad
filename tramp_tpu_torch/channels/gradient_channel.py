"""Gradient channel x = grad z: d circular first-derivative convolutions,
output shape (d,) + shape. Counterpart of
tramp_tpu/channels/gradient_channel.py, on ``torch.fft`` over the spatial
axes only (conv_channel.py says why).

Lanes: z is ``(B,) + shape`` with a precision ``(B,) + (1,) * d``; x is
``(B, d) + shape`` with a precision ``(B,) + (1,) * (d + 1)``. The lane axis
comes before the gradient's own leading axis, the FFTs run over the
trailing d axes, and the sum over the d directions runs over the axis
before them."""
import math

import numpy as np
import torch

from .base_channel import Channel
from .conv_channel import conj_spectra
from ..config import as_tensor
from ..lanes import (
    lane_count, lane_sum, like, precision_lanes, spectral, spectral_mean)
from ..utils.conv_filters import gradient_filters


class GradientChannel(Channel):
    """Reference gradient_channel.py:16-128. The spectra live on ``device``
    with ``dtype`` (None: the first card and the default dtype)."""

    _data_fields = ("filter", "w_fft", "w_fft_bar", "spectrum")
    _meta_fields = ("shape", "d", "real", "axes")

    def __init__(self, shape, real=True, device=None, dtype=None):
        super().__init__()
        self.d = len(shape)
        self.shape = tuple(shape)
        self.real = real
        f = gradient_filters(self.shape)
        self.axes = tuple(range(1, self.d + 1))
        filt = as_tensor(f, device, dtype)
        w_fft_bar = np.fft.fftn(f, axes=self.axes)
        w_fft, w_bar = conj_spectra(w_fft_bar, filt.device, filt.dtype)
        self.register_buffer("filter", filt)
        self.register_buffer("w_fft", w_fft)
        self.register_buffer("w_fft_bar", w_bar)
        self.register_buffer(
            "spectrum", as_tensor((np.abs(w_fft_bar) ** 2).sum(axis=0),
                                  filt.device, filt.dtype))

    def math(self):
        return r"$\nabla$"

    @classmethod
    def from_description(cls, data, meta, device=None, dtype=None):
        "The channel of a JAX description, its spectra rebuilt."
        return cls(meta["shape"], meta["real"], device, dtype)

    def out_shape(self, shape):
        return (self.d,) + self.shape

    def _fft(self, x, inverse=False):
        dims = tuple(range(-self.d, 0))
        return (torch.fft.ifftn if inverse else torch.fft.fftn)(x, dim=dims)

    def _real(self, x):
        # as the JAX package: real=False keeps the complex field
        return x.real if self.real else x

    def convolve(self, z):
        x = self._fft(self.w_fft * self._fft(z).unsqueeze(-self.d - 1),
                      inverse=True)
        return self._real(x)

    def sample(self, generator, Z):
        return self.convolve(Z)

    def second_moment(self, tau_z):
        return tau_z * torch.mean(self.spectrum) / self.d

    def compute_n_eff(self, az, ax):
        return like(self._n_eff(az, ax), az)

    def _n_eff(self, az, ax):
        "n_eff, one value per lane in the spectrum's axes."
        B, d = precision_lanes(az, ax), self.d
        az, ax = spectral(az, B, d), spectral(ax, B, d)
        ratio = az / torch.clamp(ax, min=1e-30)
        n_eff = spectral_mean(self.spectrum / (ratio + self.spectrum), B, d)
        return torch.where(ax == 0, 0.0, n_eff)

    def compute_backward_mean(self, az, bz, ax, bx, return_fft=False):
        B, d = lane_count(az, bz), self.d
        resolvent = 1.0 / (spectral(az, B, d)
                           + spectral(ax, B, d) * self.spectrum)
        bx_fft = self._fft(bx)
        bz_fft = self._fft(bz)
        rz_fft = resolvent * (
            bz_fft + torch.sum(self.w_fft_bar * bx_fft, dim=-d - 1))
        if return_fft:
            return rz_fft
        return self._real(self._fft(rz_fft, inverse=True))

    def compute_forward_mean(self, az, bz, ax, bx):
        rz_fft = self.compute_backward_mean(az, bz, ax, bx, return_fft=True)
        rx = self._fft(self.w_fft * rz_fft.unsqueeze(-self.d - 1),
                       inverse=True)
        return self._real(rx)

    def compute_backward_variance(self, az, ax):
        n_eff = self._n_eff(az, ax)
        B = precision_lanes(az, ax)
        return like((1.0 - n_eff) / spectral(az, B, self.d), az)

    def compute_forward_variance(self, az, ax):
        B, d = precision_lanes(az, ax), self.d
        v0 = torch.mean(self.spectrum) / spectral(az, B, d)
        n_eff = self._n_eff(az, ax)
        ax_s = spectral(ax, B, d)
        v = n_eff / (torch.clamp(ax_s, min=1e-30) * d)
        return like(torch.where(ax_s == 0, v0, v), ax)

    def compute_backward_posterior(self, az, bz, ax, bx):
        return (self.compute_backward_mean(az, bz, ax, bx),
                self.compute_backward_variance(az, ax))

    def compute_forward_posterior(self, az, bz, ax, bx):
        return (self.compute_forward_mean(az, bz, ax, bx),
                self.compute_forward_variance(az, ax))

    def compute_backward_error(self, az, ax, tau_z):
        return self.compute_backward_variance(az, ax)

    def compute_forward_error(self, az, ax, tau_z):
        return self.compute_forward_variance(az, ax)

    def compute_log_partition(self, az, bz, ax, bx):
        B = lane_count(az, bz)
        lanes = B is not None
        rz = self.compute_backward_mean(az, bz, ax, bx)
        rx = self.compute_forward_mean(az, bz, ax, bx)
        a = spectral(az, B, self.d) + spectral(ax, B, self.d) * self.spectrum
        return (0.5 * lane_sum(bz * rz, lanes) + 0.5 * lane_sum(bx * rx, lanes)
                + 0.5 * lane_sum(torch.log(2 * math.pi / a), lanes))
