"""Circular convolution channels diagonalized by the FFT: the resolvent
messages are elementwise in Fourier space. Counterpart of
tramp_tpu/channels/conv_channel.py.

The JAX package computes these FFTs with XLA outside any Pallas kernel; the
port's counterpart is ``torch.fft`` (cuFFT on the card) on torch's complex
dtypes (float32 gives complex64, float64 complex128). The spectra are
computed once with numpy in float64 from the filter and moved to the
channel's device and dtype. A complex variable (``real=False``) travels
packed re/im, ``(2,) + shape`` (utils/misc.py).

Lanes (tramp_tpu_torch/lanes.py): messages ``(B,) + shape`` (``(B, 2) +
shape`` packed) with precisions ``(B, 1, ...)``. The FFTs run over the
trailing ``len(shape)`` axes only, so the lane axis is never transformed,
and every spectral mean is taken over all spectral axes, one value per
lane."""
import math

import numpy as np
import torch

from .base_channel import Channel
from ..config import as_complex, as_tensor
from ..lanes import (
    lane_count, lane_sum, like, precision_lanes, spectral, spectral_mean)
from ..utils.conv_filters import (
    gaussian_filter, differential_filter, laplacian_filter)
from ..utils.misc import pack, unpack


def conj_spectra(w_fft_bar, device, dtype):
    "(w_fft, w_fft_bar) of a numpy spectrum, as complex buffers."
    return (as_complex(np.conjugate(w_fft_bar), device, dtype),
            as_complex(w_fft_bar, device, dtype))


class ConvChannel(Channel):
    """x = w * z (circular). filter weights w[u] = f*[-u]; w_fft = conj(f_fft).
    Reference conv_channel.py:13-165. ``filter`` is a numpy array (or a
    tensor); its spectra live on ``device`` with ``dtype`` (None: the first
    card and the default dtype)."""

    _data_fields = ("filter", "w_fft", "w_fft_bar", "spectrum")
    _meta_fields = ("shape", "real")

    def __init__(self, filter, real=True, device=None, dtype=None):
        super().__init__()
        f = (filter.detach().cpu().numpy() if isinstance(filter, torch.Tensor)
             else np.asarray(filter))
        self.shape = f.shape
        self.real = real
        filt = as_tensor(f, device, dtype)
        w_fft_bar = np.fft.fftn(f)
        w_fft, w_bar = conj_spectra(w_fft_bar, filt.device, filt.dtype)
        self.register_buffer("filter", filt)
        self.register_buffer("w_fft", w_fft)
        self.register_buffer("w_fft_bar", w_bar)
        self.register_buffer(
            "spectrum", as_tensor(np.abs(w_fft_bar) ** 2, filt.device,
                                  filt.dtype))

    def math(self):
        return r"$\ast$"

    @classmethod
    def from_description(cls, data, meta, device=None, dtype=None):
        """The channel of a JAX description: the spectra rebuilt from the
        filter, the meta fields of the subclass (``D1``, ``D2``,
        ``sigma``) set as they were."""
        ch = cls.__new__(cls)
        ConvChannel.__init__(ch, np.asarray(data["filter"]), meta["real"],
                             device, dtype)
        for field in cls._meta_fields:
            setattr(ch, field, meta[field])
        return ch

    @property
    def d(self):
        return len(self.shape)

    def _fft(self, x, inverse=False):
        dims = tuple(range(-self.d, 0))
        return (torch.fft.ifftn if inverse else torch.fft.fftn)(x, dim=dims)

    def _complex(self, b, B):
        "The complex field of a message: b itself, or its packed pair."
        return b if self.real else unpack(b, 0 if B is None else 1)

    def _message(self, c, B):
        "A complex field as a message: its real part, or packed."
        return c.real if self.real else pack(c, 0 if B is None else 1)

    def convolve(self, z):
        x = self._fft(self.w_fft * self._fft(z), inverse=True)
        return x.real if self.real else x

    def sample(self, generator, Z):
        if not self.real:
            Z = unpack(Z)
        X = self.convolve(Z)
        return X if self.real else pack(X)

    def second_moment(self, tau_z):
        return tau_z * torch.mean(self.spectrum)

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
        B = lane_count(az, bz)
        resolvent = 1.0 / (spectral(az, B, self.d)
                           + spectral(ax, B, self.d) * self.spectrum)
        bx_fft = self._fft(self._complex(bx, B))
        bz_fft = self._fft(self._complex(bz, B))
        rz_fft = resolvent * (bz_fft + self.w_fft_bar * bx_fft)
        if return_fft:
            return rz_fft
        return self._message(self._fft(rz_fft, inverse=True), B)

    def compute_forward_mean(self, az, bz, ax, bx):
        rz_fft = self.compute_backward_mean(az, bz, ax, bx, return_fft=True)
        rx = self._fft(self.w_fft * rz_fft, inverse=True)
        return self._message(rx, lane_count(az, bz))

    def compute_backward_variance(self, az, ax):
        n_eff = self._n_eff(az, ax)
        B = precision_lanes(az, ax)
        return like((1.0 - n_eff) / spectral(az, B, self.d), az)

    def compute_forward_variance(self, az, ax):
        B, d = precision_lanes(az, ax), self.d
        v0 = torch.mean(self.spectrum) / spectral(az, B, d)
        n_eff = self._n_eff(az, ax)
        ax_s = spectral(ax, B, d)
        v = n_eff / torch.clamp(ax_s, min=1e-30)
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
        coef = 0.5 if self.real else 1.0
        return (0.5 * lane_sum(bz * rz, lanes) + 0.5 * lane_sum(bx * rx, lanes)
                + coef * lane_sum(torch.log(2 * math.pi / a), lanes))

    def compute_mutual_information(self, az, ax, tau_z):
        B, d = precision_lanes(az, ax, tau_z), self.d
        a = spectral(az, B, d) + spectral(ax, B, d) * self.spectrum
        I = spectral_mean(0.5 * torch.log(a * spectral(tau_z, B, d)), B, d)
        return like(I, az if isinstance(az, torch.Tensor) else ax)

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + ax * tau_x) - I
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))


class DifferentialChannel(ConvChannel):
    _meta_fields = ("shape", "real", "D1", "D2")

    def __init__(self, D1, D2, shape, real=True, device=None, dtype=None):
        self.D1 = tuple(np.ravel(D1))
        self.D2 = tuple(np.ravel(D2)) if D2 is not None else None
        f = differential_filter(shape=shape, D1=D1, D2=D2)
        super().__init__(filter=f, real=real, device=device, dtype=dtype)

    def math(self):
        return r"$\partial$"


class LaplacianChannel(ConvChannel):
    def __init__(self, shape, real=True, device=None, dtype=None):
        super().__init__(filter=laplacian_filter(shape), real=real,
                         device=device, dtype=dtype)

    def math(self):
        return r"$\Delta$"


class Blur1DChannel(ConvChannel):
    _meta_fields = ("shape", "real", "sigma")

    def __init__(self, sigma, N, real=True, device=None, dtype=None):
        self.sigma = sigma
        super().__init__(filter=gaussian_filter(sigma=sigma, N=N), real=real,
                         device=device, dtype=dtype)


class Blur2DChannel(ConvChannel):
    _meta_fields = ("shape", "real", "sigma")

    def __init__(self, sigma, shape, real=True, device=None, dtype=None):
        if len(sigma) != 2:
            raise ValueError("sigma must be a length 2 array")
        if len(shape) != 2:
            raise ValueError("shape must be a length 2 tuple")
        self.sigma = tuple(sigma)
        f0 = gaussian_filter(sigma=sigma[0], N=shape[0])
        f1 = gaussian_filter(sigma=sigma[1], N=shape[1])
        super().__init__(filter=np.outer(f0, f1), real=real, device=device,
                         dtype=dtype)
