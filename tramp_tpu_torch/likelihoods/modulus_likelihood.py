"""Modulus likelihood y = |z| for complex z (phase retrieval). Counterpart
of tramp_tpu/likelihoods/modulus_likelihood.py.

A complex array is packed as a real one with an axis of length 2 (real
part, imaginary part), the variable's first axis: ``(2, N)`` for one
instance. With lanes the lane axis comes first, ``(B, 2, N)``, so the
packed axis is found from the precision that travels with the message
(``_packed_axis``), never by indexing ``[0]``."""
import math

import torch

from .base_likelihood import Likelihood
from ..config import as_tensor
from ..utils.integration import gaussian_measure, gaussian_measure_2d


def i0e(x):
    "Exponentially scaled modified Bessel function I0."
    return torch.special.i0e(x)


def i1e(x):
    "Exponentially scaled modified Bessel function I1."
    return torch.special.i1e(x)


def ive_ratio(r):
    "I(r) = I1e(r)/I0e(r), ~1 for r >> 1. Reference l:9-20."
    return i1e(r) / i0e(r)


def _lanes(a, like):
    """B when the precision ``a`` is one value per lane of ``like`` (its
    first axis), else None. Unlike ``lanes.lane_count`` the number of axes
    may differ: an SE precision is ``(B, 1)`` whatever the nodes' shape."""
    if (isinstance(a, torch.Tensor) and a.ndim >= 1
            and a.numel() == a.shape[0] == like.shape[0]):
        return a.shape[0]
    return None


def _packed_axis(az, bz):
    "The re/im axis of a packed ``bz``: 1 with lanes, else 0."
    return 0 if _lanes(az, bz) is None else 1


def pair_abs(bz, axis=0):
    """|bz| for packed bz. Gradient-safe at bz = 0 (the log partitions are
    smooth even functions of |bz|, so the true gradient there is 0)."""
    sq = bz.select(axis, 0) ** 2 + bz.select(axis, 1) ** 2
    safe = torch.where(sq == 0, 1.0, sq)
    return torch.where(sq == 0, 0.0, torch.sqrt(safe))


def pair_normalize(bz, axis=0):
    "bz / |bz| for packed bz, 0 where bz == 0. Reference l:23-29."
    b = pair_abs(bz, axis).unsqueeze(axis)
    return torch.where(b == 0, 0.0, bz / torch.where(b == 0, 1.0, b))


class ModulusLikelihood(Likelihood):
    """``y`` (the moduli, of the variable's shape without the packed axis)
    is a buffer on ``device`` with ``dtype`` (None: those of a tensor ``y``,
    else the defaults of tramp_tpu_torch.config); with lanes, ``(B, N)``."""

    _data_fields = ("y",)
    _meta_fields = ("y_name", "isotropic")

    def __init__(self, y, y_name="y", isotropic=True, device=None,
                 dtype=None):
        super().__init__()
        self.y_name = y_name
        self.isotropic = isotropic
        self.register_buffer(
            "y", None if y is None else as_tensor(y, device, dtype))

    def math(self):
        return r"$|\cdot|$"

    def sample(self, generator, Z):
        return pair_abs(Z)

    def scalar_backward_mean(self, az, bz, y):
        "Packed (re/im) posterior mean y*I along the bz phase direction."
        axis = _packed_axis(az, bz)
        I = ive_ratio(pair_abs(bz, axis) * y)
        return pair_normalize(bz, axis) * (y * I).unsqueeze(axis)

    def scalar_backward_variance(self, az, bz, y):
        I = ive_ratio(pair_abs(bz, _packed_axis(az, bz)) * y)
        # 0.5 factor: averaging over the complex coordinate
        return 0.5 * y**2 * (1.0 - I**2)

    def scalar_log_partition(self, az, bz, y):
        packed = bz.ndim > torch.as_tensor(y).ndim
        b = pair_abs(bz, _packed_axis(az, bz)) if packed else torch.abs(bz)
        return (-0.5 * az * y**2
                + torch.log(2 * math.pi * y * i0e(b * y)) + b * y)

    def _isotropic_mean(self, az, x):
        "Mean over the variable's elements: az's shape, one value per lane."
        B = _lanes(az, x)
        if B is None:
            return torch.mean(x)
        return x.reshape(B, -1).mean(-1).reshape(az.shape)

    def compute_backward_posterior(self, az, bz, y):
        axis = _packed_axis(az, bz)
        I = ive_ratio(pair_abs(bz, axis) * y)
        rz = pair_normalize(bz, axis) * (y * I).unsqueeze(axis)
        vz = 0.5 * y**2 * (1.0 - I**2)
        if self.isotropic:
            vz = self._isotropic_mean(az, vz)
        return rz, vz

    def compute_log_partition(self, az, bz, y):
        b = pair_abs(bz, _packed_axis(az, bz))
        a = az.reshape(az.shape[:1] + (1,) * (b.ndim - 1)) \
            if _lanes(az, bz) is not None else az
        A = (-0.5 * a * y**2
             + torch.log(2 * math.pi * y * i0e(b * y)) + b * y)
        # 0.5 factor: averaging over the complex coordinate
        return self._isotropic_mean(az, A) / 2

    def beliefs_measure(self, az, tau_z, f):
        """Reference l:101-120. The reference branches on u_eff == 0
        (uninformative belief az*tau_z <= 1: no integration over b); here
        both branches are evaluated and one is selected per lane."""
        u_eff = torch.clamp(az * tau_z - 1.0, min=0.0)
        pos = u_eff > 0
        u_safe = torch.where(pos, u_eff, 1.0)
        sz_eff = torch.sqrt(az * u_safe)
        zero, one = torch.zeros_like(sz_eff), torch.ones_like(sz_eff)

        def packed(re, im, like):
            return torch.stack([re, im], dim=_packed_axis(az, like))

        # typical case u_eff > 0:
        # integrand relu(b)*relu(y)*ive(0, b y)*f (ive = scaled Bessel i0e)
        def f_typical(xi_b, xi_y):
            b = sz_eff * xi_b
            y = b / az + xi_y / torch.sqrt(az)
            coef = 2 * math.pi / torch.sqrt(u_safe)
            bz = packed(b, torch.zeros_like(b), b)
            return (coef * torch.clamp(b, min=0.0) * torch.clamp(y, min=0.0)
                    * i0e(b * y) * f(bz, y))

        I_typical = gaussian_measure_2d(zero, one, zero, one, f_typical)

        # special case az*tau_z <= 1 (b pinned at 0, 1D measure over y)
        def f_zero(xi_y):
            y = xi_y / torch.sqrt(az)
            coef_y = torch.sqrt(2 * math.pi * az)
            bz = packed(torch.zeros_like(y), torch.zeros_like(y), y)
            return coef_y * torch.clamp(y, min=0.0) * f(bz, y)

        I_zero = gaussian_measure(zero, one, f_zero)
        return torch.where(pos, I_typical, I_zero)
