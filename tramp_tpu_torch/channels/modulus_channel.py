r"""Modulus channel x = |z| for complex z packed as real (2, ...) arrays.
Counterpart of tramp_tpu/channels/modulus_channel.py, which derives the
posteriors that the reference leaves unimplemented.

Math. With incoming Gaussian beliefs exp(-az|z|^2/2 + bz.z) on z (complex,
2 real coordinates) and exp(-ax x^2/2 + bx x) on x = |z|, the tilted joint
in polar coordinates z = rho e^{i theta} integrates over the phase to

    p(rho) \propto rho exp(-(az+ax) rho^2/2 + bx rho) I0(|bz| rho)

and every posterior moment is a radial integral, taken with a fixed
composite Gauss-Legendre rule on the +/- 12 sigma bracket of the
integrand's peak (``_radial_moments``).

Axes. The JAX package puts the radial nodes on a new leading axis; here
they take a new trailing axis, so that the lane axis stays first: a message
``bz`` is ``(2, N)``, or ``(B, 2, N)`` with lanes (packed axis 1, found from
the precision beside it), ``bx`` is ``(N,)`` or ``(B, N)``, and a precision
one value per lane is lifted to the shape of the moduli before use. The SE
measure's quadrature axes follow the lane axis in the same way.
"""
import math

import torch

from .base_channel import Channel
from ..lanes import sqrt
from ..likelihoods.modulus_likelihood import (
    _lanes, _packed_axis, i0e, i1e, pair_abs, pair_normalize)
from ..utils.integration import (
    _like, composite_gauss_legendre, rule_on, std_normal_nodes)

#: radial quadrature: panels x order nodes over the peak bracket
_R_PANELS = 8
_R_ORDER = 16
#: half-width of the radial bracket in posterior standard deviations
_R_RANGE = 12.0
#: lighter node counts for the (already 3D) SE ensemble measure
_SE_R_PANELS = 4
_SE_R_ORDER = 8
_SE_GRID = (8, 8)


def _lift(a, ndim):
    """A precision that is one value per lane, ``(B, 1, ...)``, as ``(B,)``
    followed by ``ndim - 1`` axes of length 1; a number or a 0-d tensor as
    it is."""
    if isinstance(a, torch.Tensor) and a.ndim >= 1:
        return a.reshape((a.shape[0],) + (1,) * (ndim - 1))
    return a


def _radial_moments(az, bz, ax, bx, panels=_R_PANELS, order=_R_ORDER):
    r"""Radial posterior moments of p(rho) ~ rho e^{-a rho^2/2 + bx rho}
    I0(b rho) on rho > 0, b = |bz|.

    Returns (m1, m2, mI, logZ) elementwise over the shape of the moduli:
    E[rho], E[rho^2], E[rho I1/I0(b rho)], and the log-partition
    log \int_0^inf 2 pi rho e^{...} I0(b rho) drho.
    """
    b = pair_abs(bz, _packed_axis(az, bz))
    ndim = max(b.ndim, bx.ndim)
    a = torch.clamp(_lift(az, ndim) + _lift(ax, ndim), min=1e-11)
    sigma = 1.0 / torch.sqrt(a)

    # peak bracket: g'(rho) = -a rho + c_eff + 1/rho with the Bessel slope
    # c_eff = bx + b (I1/I0)(b rho) in [bx, bx + b]; bracket the roots for
    # both extremes and pad by _R_RANGE sigmas
    def peak(c):
        return (c + torch.sqrt(c**2 + 4.0 * a)) / (2.0 * a)

    lo = torch.clamp(peak(bx) - _R_RANGE * sigma, min=0.0)
    hi = peak(bx + b) + _R_RANGE * sigma
    xs, ws = rule_on(b, composite_gauss_legendre, 0.0, 1.0, panels, order)
    width = (hi - lo)[..., None]
    rho = lo[..., None] + width * xs          # shape + (K,), all rho > 0
    b_, a_ = b[..., None], a[..., None]
    i0e_ = i0e(b_ * rho)
    g = (-0.5 * a_ * rho**2 + (bx[..., None] + b_) * rho
         + torch.log(i0e_) + torch.log(rho) + torch.log(width * ws))
    g_max = torch.amax(g, dim=-1)
    p = torch.exp(g - g_max[..., None])
    Z = torch.sum(p, dim=-1)
    p = p / Z[..., None]
    m1 = torch.sum(p * rho, dim=-1)
    m2 = torch.sum(p * rho**2, dim=-1)
    # ive_ratio, with the i0e above
    mI = torch.sum(p * rho * (i1e(b_ * rho) / i0e_), dim=-1)
    logZ = math.log(2 * math.pi) + g_max + torch.log(Z)
    return m1, m2, mI, logZ


class ModulusChannel(Channel):

    _data_fields = ()
    _meta_fields = ("isotropic",)

    def __init__(self, isotropic=True):
        super().__init__()
        self.isotropic = isotropic

    def math(self):
        return r"$|\cdot|$"

    def out_shape(self, shape):
        return tuple(shape[1:])

    def sample(self, generator, Z):
        return pair_abs(Z)

    def second_moment(self, tau_z):
        return 2 * tau_z

    @staticmethod
    def _isotropic_mean(a, v):
        "Mean over the elements: 0-d, or one value per lane of a's shape."
        B = _lanes(a, v)
        if B is None:
            return torch.mean(v)
        return v.reshape(B, -1).mean(-1).reshape(a.shape)

    # -- posteriors --------------------------------------------------------
    def scalar_backward_mean(self, az, bz, ax, bx):
        axis = _packed_axis(az, bz)
        _, _, mI, _ = _radial_moments(az, bz, ax, bx)
        return pair_normalize(bz, axis) * mI.unsqueeze(axis)

    def scalar_backward_variance(self, az, bz, ax, bx):
        _, m2, mI, _ = _radial_moments(az, bz, ax, bx)
        return 0.5 * (m2 - mI**2)

    def scalar_forward_mean(self, az, bz, ax, bx):
        return _radial_moments(az, bz, ax, bx)[0]

    def scalar_forward_variance(self, az, bz, ax, bx):
        m1, m2, _, _ = _radial_moments(az, bz, ax, bx)
        return m2 - m1**2

    def compute_backward_posterior(self, az, bz, ax, bx):
        axis = _packed_axis(az, bz)
        _, m2, mI, _ = _radial_moments(az, bz, ax, bx)
        rz = pair_normalize(bz, axis) * mI.unsqueeze(axis)
        vz = 0.5 * (m2 - mI**2)
        if self.isotropic:
            vz = self._isotropic_mean(az, vz)
        elif axis == 1:
            vz = vz.unsqueeze(1)
        return rz, vz

    def compute_forward_posterior(self, az, bz, ax, bx):
        m1, m2, _, _ = _radial_moments(az, bz, ax, bx)
        vx = m2 - m1**2
        if self.isotropic:
            vx = self._isotropic_mean(ax, vx)
        return m1, vx

    def compute_log_partition(self, az, bz, ax, bx):
        """Extensive log-partition, summed over complex elements (each
        element's radial integral is the joint over its 2 real coords,
        matching the ComplexLinearChannel convention); one value per lane
        with lanes."""
        logZ = _radial_moments(az, bz, ax, bx)[3]
        B = _lanes(az, bz)
        return torch.sum(logZ) if B is None else logZ.reshape(B, -1).sum(-1)

    def scalar_log_partition(self, az, bz, ax, bx):
        return _radial_moments(az, bz, ax, bx)[3]

    # -- SE measure ---------------------------------------------------------
    # SE errors go through a lighter radial rule: the ensemble measure is
    # already 3D (xi_b, xi_y, xi_bx), so the inner radial integral uses
    # _SE_R_* nodes to bound the quadrature tensor
    def compute_forward_error(self, az, ax, tau_z):
        def variance(bz, bx):
            m1, m2, _, _ = _radial_moments(
                az, bz, ax, bx, _SE_R_PANELS, _SE_R_ORDER)
            return m2 - m1**2
        return self.beliefs_measure(az, ax, tau_z, f=variance)

    def compute_backward_error(self, az, ax, tau_z):
        def variance(bz, bx):
            _, m2, mI, _ = _radial_moments(
                az, bz, ax, bx, _SE_R_PANELS, _SE_R_ORDER)
            return 0.5 * (m2 - mI**2)
        return self.beliefs_measure(az, ax, tau_z, f=variance)

    def compute_free_energy(self, az, ax, tau_z):
        def log_partition(bz, bx):
            return _radial_moments(
                az, bz, ax, bx, _SE_R_PANELS, _SE_R_ORDER)[3]
        return self.beliefs_measure(az, ax, tau_z, f=log_partition)

    def compute_mutual_information(self, az, ax, tau_z):
        """The generic Channel formula assumes one real coordinate per
        element; the modulus input z has two (complex), so the az tau_z
        energy and the Gaussian entropy terms double."""
        tau_x = self.second_moment(tau_z)
        A = self.compute_free_energy(az, ax, tau_z)
        return (0.5 * (2 * az * tau_z + ax * tau_x) - A
                + torch.log(2 * math.pi * tau_z / math.e))

    def beliefs_measure(self, az, ax, tau_z, f):
        """Bayes-optimal ensemble average of f(bz, bx): the (b=|bz|, y=rho*)
        measure of the modulus likelihood with bx | y ~ N(ax y, ax) on a
        third quadrature axis, the y integral over [0, inf) with
        truncated-normal nodes and the xi_b nodes on the positive half-line
        (the JAX package's rule). ``az``, ``ax``, ``tau_z`` are numbers or
        0-d tensors, or one value per lane ``(B, 1)``; with lanes every
        quadrature array carries the lane axis first and the result is
        ``(B, 1)``."""
        device, dtype, lanes = _like(az, ax, tau_z)
        az = torch.as_tensor(az, dtype=dtype, device=device)
        like = az
        u_eff = torch.clamp(az * tau_z - 1.0, min=0.0)
        pos = u_eff > 0
        u_safe = torch.where(pos, u_eff, 1.0)
        sz_eff = torch.sqrt(az * u_safe)
        xbx, wbx = rule_on(like, std_normal_nodes, *_SE_GRID)

        def packed(re):
            "(re, 0) packed on the axis after the lanes."
            return torch.stack([re, torch.zeros_like(re)],
                               dim=1 if lanes else 0)

        def with_bx(bz, y):
            "E_{bx ~ N(ax y, ax)} f(bz, bx) on a trailing node axis."
            a = _lift(ax, y.ndim + 1)
            bx = a * y[..., None] + sqrt(a) * xbx
            return torch.sum(wbx * f(bz[..., None], bx), dim=-1)

        def y_measure(m, s, g):
            """sum of N(y | m, s^2) g(y) over y > 0 on a trailing node
            axis; composite GL in y-space with the density in the
            weights."""
            u, w = rule_on(like, composite_gauss_legendre, 0.0, 1.0, 8, 8)
            lo = torch.clamp(m - 10.0 * s, min=0.0)
            hi = torch.maximum(m + 10.0 * s, lo + 10.0 * s)
            s_ = s[..., None]
            y = lo[..., None] + (hi - lo)[..., None] * u
            dens = torch.exp(-0.5 * ((y - m[..., None]) / s_) ** 2) / (
                math.sqrt(2 * math.pi) * s_)
            wy = (hi - lo)[..., None] * w * dens
            return torch.sum(wy * g(y), dim=-1)

        # typical case u_eff > 0: static positive-half xi_b nodes
        xb, wb = rule_on(like, std_normal_nodes, 8, 12)
        keep = xb > 0
        xb, wb = xb[keep], wb[keep]
        b = sz_eff * xb                          # (Kb,) or (B, Kb)
        bz_b = packed(b)
        coef = 2 * math.pi / torch.sqrt(u_safe)
        s = 1.0 / torch.sqrt(az)

        def g_typical(y):
            # y: (Kb, Ky), lanes first
            bzy = torch.broadcast_to(bz_b[..., None],
                                     bz_b.shape + (y.shape[-1],))
            b_ = b[..., None]
            return (_lift(coef, y.ndim) * b_ * y * i0e(b_ * y)
                    * with_bx(bzy, y))

        inner = y_measure(b / az, s, g_typical)
        I_typical = torch.sum(wb * inner, dim=-1, keepdim=lanes)

        # special case az*tau_z <= 1 (b pinned at 0, 1D measure over y > 0)
        def g_zero(y):
            return (_lift(torch.sqrt(2 * math.pi * az), y.ndim) * y
                    * with_bx(packed(torch.zeros_like(y)), y))

        I_zero = y_measure(torch.zeros_like(s), s, g_zero)
        return torch.where(pos, I_typical, I_zero)
