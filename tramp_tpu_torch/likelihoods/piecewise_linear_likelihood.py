"""Piecewise-linear likelihoods (relu, leaky-relu, hard-tanh, ...).
Counterpart of tramp_tpu/likelihoods/piecewise_linear_likelihood.py.

Each region computes its own moments here (truncated-normal beliefs); the
five-output kernel of the piecewise-linear channels (ops/pl_fused.py) is
not on this path. The SE measures use the probit-transformed truncated
Gaussian rule, so that region indicators are represented exactly, with
boundary panels where the integrands have layers; a nested rule hands its
integrand the inner and outer nodes as one node axis
(``utils.integration.flat_call``)."""
import math

import torch

from .base_likelihood import Likelihood
from ..beliefs import truncated
from ..config import as_tensor
from ..lanes import lane_mean
from ..utils.integration import (
    composite_gauss_legendre, flat_call, gaussian_measure,
    gaussian_measure_boundary, inner_axis, inner_gaussian_measure, rule_on,
    sqrt_like, truncated_gaussian_measure,
)
from ..utils.special import norm_cdf

_INF = math.inf


def _points(centers, widths):
    """The boundary-panel breakpoints ``c - w``, ``c + w`` (and so on for
    every width) of every center, along the last axis: ``(P,)``, or
    ``(B, P)`` with lanes."""
    return torch.cat([torch.atleast_1d(c + w) for c in centers
                      for w in widths], -1)


class LinearRegionLikelihood:
    "One region: z in [zmin, zmax], y = x0 + slope*z. Reference l:9-155."

    def __init__(self, zmin, zmax, x0, slope):
        if not zmin < zmax:
            raise ValueError(f"need zmin < zmax, got [{zmin}, {zmax}]")
        self.zmin = zmin
        self.zmax = zmax
        self.x0 = x0
        self.slope = slope

    def x(self, z):
        return self.x0 + self.slope * z

    def strict_indicator(self, z):
        return (self.zmin < z) & (z < self.zmax)

    def sample(self, Z):
        return self.x(Z) * (self.zmin <= Z) * (Z < self.zmax)

    def contains(self, y):
        if self.slope == 0:
            return y == self.x0
        z = (y - self.x0) / self.slope
        return self.strict_indicator(z)

    def backward_mean(self, az, bz, y):
        if self.slope == 0:
            rz = truncated.r(az, bz, self.zmin, self.zmax)
        else:
            rz = (y - self.x0) / self.slope
        return torch.where(self.contains(y), rz, 0.0)

    def backward_variance(self, az, bz, y):
        if self.slope == 0:
            vz = truncated.v(az, bz, self.zmin, self.zmax)
        else:
            vz = torch.zeros_like(az * bz * y)
        return torch.where(self.contains(y), vz, 0.0)

    def log_partitions(self, az, bz, y):
        if self.slope == 0:
            logZ = truncated.A(az, bz, self.zmin, self.zmax)
        else:
            z = (y - self.x0) / self.slope
            logZ = -0.5 * az * z**2 + bz * z - math.log(abs(self.slope))
        return torch.where(self.contains(y), logZ, -_INF)

    def _x0_like(self, bz):
        # x0 broadcast to bz: f may stack per-region results over regions
        # of mixed slope (PiecewiseLinearLikelihood._merge)
        return torch.full_like(bz, self.x0)

    def b_measure(self, mz_hat, qz_hat, tz0_hat, f):
        tz0 = 1.0 / tz0_hat
        if self.slope == 0:
            az_star = mz_hat**2 / qz_hat + tz0_hat

            def p_times_f(bz):
                bz_star = (mz_hat / qz_hat) * bz
                p = truncated.p(az_star, bz_star, self.zmin, self.zmax)
                return p * f(bz, self._x0_like(bz))

            sz_eff = torch.sqrt(qz_hat + mz_hat**2 * tz0)
            return gaussian_measure(0.0, sz_eff, p_times_f)

        # slope != 0: z restricted to the region (outer truncated probit
        # rule), xi_b standard normal (inner rule)
        def outer(z):
            return inner_gaussian_measure(mz_hat * z, torch.sqrt(qz_hat), f,
                                          self.x(z))

        return truncated_gaussian_measure(
            0.0, sqrt_like(tz0, mz_hat), self.zmin, self.zmax, outer)

    def bz_measure(self, mz_hat, qz_hat, tz0_hat, f):
        tz0 = 1.0 / tz0_hat
        if self.slope == 0:
            az_star = mz_hat**2 / qz_hat + tz0_hat

            def rp_times_f(bz):
                bz_star = (mz_hat / qz_hat) * bz
                r = truncated.r(az_star, bz_star, self.zmin, self.zmax)
                p = truncated.p(az_star, bz_star, self.zmin, self.zmax)
                return r * p * f(bz, self._x0_like(bz))

            sz_eff = torch.sqrt(qz_hat + mz_hat**2 * tz0)
            return gaussian_measure(0.0, sz_eff, rp_times_f)

        def outer(z):
            return z * inner_gaussian_measure(
                mz_hat * z, torch.sqrt(qz_hat), f, self.x(z))

        return truncated_gaussian_measure(
            0.0, sqrt_like(tz0, mz_hat), self.zmin, self.zmax, outer)

    def beliefs_measure(self, az, tau_z, f, panel_z=()):
        # floor at AMIN: the reference asserts az > 1/tau_z strictly
        # (sgn_likelihood.py:81); at the uninformed point az == 1/tau_z
        # the measure degenerates, and a tiny positive floor keeps it
        # defined while preserving the instability of that fixed point
        mz_hat = torch.clamp(az - 1.0 / tau_z, min=1e-11)
        bounds = [z for z in {self.zmin, self.zmax, *panel_z}
                  if math.isfinite(z)]
        if self.slope == 0:
            def integrand(bz):
                p = truncated.p(az, bz, self.zmin, self.zmax)
                return p * f(bz, self._x0_like(bz))
            sz_eff = torch.sqrt(mz_hat + mz_hat**2 * tau_z)
            # boundary panels: the integrand's informative structure sits in
            # layers of width ~sqrt(az) around b = az * z_b for every finite
            # region boundary z_b (the truncation window of N(b/az, 1/az)).
            # At large az the layer is a vanishing fraction of sz_eff ~ az,
            # and the correction 1/az - v ~ az^{-3/2} that drives the SE
            # recovery cascade is lost without dedicated segments.
            if bounds:
                L = 10.0 * torch.sqrt(az)
                pts = _points([az * z for z in bounds], (-L, L))
                return gaussian_measure_boundary(0.0, sz_eff, pts, integrand)
            return gaussian_measure(0.0, sz_eff, integrand)

        # slope != 0: exact Gaussian factorization with bz OUTER.
        #   z ~ N(0, tau) on [zmin, zmax], bz | z ~ N(mz_hat z, mz_hat)
        # = bz ~ N(0, s_b^2), z | bz ~ N(c bz, s_c^2) truncated to the region
        # The merged integrand f(bz, y) has TWO boundary-layer scales in bz:
        # truncation layers of width ~sqrt(az) at bz = az*z_b, and region
        # log-partition crossings of width O(1) at the same centers (e.g.
        # the +-z sign ambiguity of abs at bz ~ 0). Outer panels carry both
        # scales; the inner probit rule represents the region indicator
        # exactly.
        s_b2 = mz_hat + mz_hat**2 * tau_z
        s_b = torch.sqrt(s_b2)
        c = mz_hat * tau_z / s_b2
        s_c = torch.sqrt(tau_z / (mz_hat * tau_z + 1.0))

        def outer(bz):
            u_in, w_in = rule_on(bz, composite_gauss_legendre, 0.0, 1.0, 12,
                                 12)
            m_c = c * bz
            lo = (torch.zeros_like(m_c) if self.zmin == -_INF
                  else norm_cdf((self.zmin - m_c) / s_c))
            hi = (torch.ones_like(m_c) if self.zmax == _INF
                  else norm_cdf((self.zmax - m_c) / s_c))
            mass = (hi - lo)[..., None]
            p = torch.clamp(lo[..., None] + u_in * mass, 1e-300, 1.0 - 1e-16)
            z = m_c[..., None] + inner_axis(s_c) * torch.special.ndtri(p)
            vals = flat_call(f, bz[..., None], self.x(z))
            return torch.sum(mass * w_in * vals, -1)

        if bounds:
            L1 = 10.0 * torch.sqrt(az)   # truncation layers
            L2 = 10.0                    # crossing layers
            pts = _points([az * z for z in bounds], (-L1, -L2, L2, L1))
            return gaussian_measure_boundary(0.0, s_b, pts, outer)
        return gaussian_measure(0.0, s_b, outer)


class PiecewiseLinearLikelihood(Likelihood):
    """Mixture of linear regions on the observation side. Reference
    l:157-242. ``y`` is a buffer on ``device`` with ``dtype`` (None: those
    of a tensor ``y``, else the defaults of tramp_tpu_torch.config); with
    lanes, ``(B, M)``. The regions are shared by all lanes."""

    _data_fields = ("y",)
    _meta_fields = ("name", "region_specs", "y_name", "isotropic")

    def __init__(self, name, regions, y, y_name="y", isotropic=True,
                 device=None, dtype=None):
        super().__init__()
        self.y_name = y_name
        self.isotropic = isotropic
        self.name = name
        self.register_buffer(
            "y", None if y is None else as_tensor(y, device, dtype))
        self.region_specs = tuple(
            (r["zmin"], r["zmax"], r["x0"], r["slope"]) for r in regions)

    def math(self):
        return rf"$\mathrm{{{self.name}}}$"

    @property
    def regions(self):
        return [LinearRegionLikelihood(zmin=a, zmax=b, x0=x0, slope=s)
                for (a, b, x0, s) in self.region_specs]

    @property
    def n_regions(self):
        return len(self.region_specs)

    def sample(self, generator, Z):
        return sum(region.sample(Z) for region in self.regions)

    def _merge(self, az, bz, y):
        regions = self.regions
        # broadcast before stacking: slope!=0 regions return y-shaped
        # results, slope==0 regions bz-shaped
        rs = torch.stack(torch.broadcast_tensors(
            *[rg.backward_mean(az, bz, y) for rg in regions]), 0)
        vs = torch.stack(torch.broadcast_tensors(
            *[rg.backward_variance(az, bz, y) for rg in regions]), 0)
        As = torch.stack(torch.broadcast_tensors(
            *[rg.log_partitions(az, bz, y) for rg in regions]), 0)
        # quadrature nodes can land a rounding error outside every region
        # (y infinitesimally past a strict boundary): all As = -inf would
        # make the softmax NaN; such points carry ~zero measure, any finite
        # value works
        all_off = ~torch.isfinite(torch.amax(As, dim=0, keepdim=True))
        As = torch.where(all_off, 0.0, As)
        ps = torch.softmax(As, dim=0)
        rz = torch.sum(ps * rs, dim=0)
        Dr = torch.sum(ps * rs**2, dim=0) - rz**2
        vz = torch.sum(ps * vs, dim=0) + Dr
        return rz, vz

    def scalar_backward_mean(self, az, bz, y):
        return self._merge(az, bz, y)[0]

    def scalar_backward_variance(self, az, bz, y):
        return self._merge(az, bz, y)[1]

    def scalar_log_partition(self, az, bz, y):
        As = torch.stack(torch.broadcast_tensors(
            *[rg.log_partitions(az, bz, y) for rg in self.regions]), 0)
        return torch.logsumexp(As, dim=0)

    def compute_backward_posterior(self, az, bz, y):
        rz, vz = self._merge(az, bz, y)
        if self.isotropic:
            vz = lane_mean(vz, az)
        return rz, vz

    def compute_log_partition(self, az, bz, y):
        return lane_mean(self.scalar_log_partition(az, bz, y), az)

    def b_measure(self, mz_hat, qz_hat, tz0_hat, f):
        return sum(rg.b_measure(mz_hat, qz_hat, tz0_hat, f)
                   for rg in self.regions)

    def bz_measure(self, mz_hat, qz_hat, tz0_hat, f):
        return sum(rg.bz_measure(mz_hat, qz_hat, tz0_hat, f)
                   for rg in self.regions)

    def beliefs_measure(self, az, tau_z, f):
        # f merges over ALL regions given y, so every slope-0 region's
        # measure needs boundary panels at every region bound (e.g. the
        # door's inner-region term has f-structure at both +-width)
        panel_z = tuple(
            z for (a, b, _, _) in self.region_specs for z in (a, b)
            if math.isfinite(z))
        return sum(rg.beliefs_measure(az, tau_z, f, panel_z=panel_z)
                   for rg in self.regions)


class ReluLikelihood(PiecewiseLinearLikelihood):
    def __init__(self, y, y_name="y", isotropic=True, device=None,
                 dtype=None):
        neg = dict(zmin=-_INF, zmax=0.0, slope=0.0, x0=0.0)
        pos = dict(zmin=0.0, zmax=_INF, slope=1.0, x0=0.0)
        super().__init__("relu", [pos, neg], y, y_name, isotropic, device,
                         dtype)


class LeakyReluLikelihood(PiecewiseLinearLikelihood):
    _meta_fields = ("name", "region_specs", "y_name", "isotropic", "slope")

    def __init__(self, slope, y, y_name="y", isotropic=True, device=None,
                 dtype=None):
        neg = dict(zmin=-_INF, zmax=0.0, slope=slope, x0=0.0)
        pos = dict(zmin=0.0, zmax=_INF, slope=1.0, x0=0.0)
        super().__init__("l-relu", [pos, neg], y, y_name, isotropic, device,
                         dtype)
        self.slope = slope


class AsymmetricAbsLikelihood(PiecewiseLinearLikelihood):
    _meta_fields = ("name", "region_specs", "y_name", "isotropic", "shift")

    def __init__(self, y, y_name="y", isotropic=True, shift=1e-4,
                 device=None, dtype=None):
        neg = dict(zmin=-_INF, zmax=shift, slope=-1.0, x0=0.0)
        pos = dict(zmin=shift, zmax=_INF, slope=+1.0, x0=0.0)
        super().__init__("a-abs", [pos, neg], y, y_name, isotropic, device,
                         dtype)
        self.shift = shift


class HardTanhLikelihood(PiecewiseLinearLikelihood):
    def __init__(self, y, y_name="y", isotropic=True, device=None,
                 dtype=None):
        neg = dict(zmin=-_INF, zmax=-1.0, slope=0.0, x0=-1.0)
        mid = dict(zmin=-1.0, zmax=+1.0, slope=1.0, x0=0.0)
        pos = dict(zmin=+1.0, zmax=_INF, slope=0.0, x0=+1.0)
        super().__init__("h-tanh", [pos, mid, neg], y, y_name, isotropic,
                         device, dtype)


class HardSigmoidLikelihood(PiecewiseLinearLikelihood):
    def __init__(self, y, y_name="y", isotropic=True, device=None,
                 dtype=None):
        L = 3.0
        neg = dict(zmin=-_INF, zmax=-L, slope=0.0, x0=0.0)
        mid = dict(zmin=-L, zmax=+L, slope=1.0 / (2 * L), x0=0.5)
        pos = dict(zmin=L, zmax=_INF, slope=0.0, x0=1.0)
        super().__init__("h-sigm", [pos, mid, neg], y, y_name, isotropic,
                         device, dtype)


class SymmetricDoorLikelihood(PiecewiseLinearLikelihood):
    _meta_fields = ("name", "region_specs", "y_name", "isotropic", "width")

    def __init__(self, width, y, y_name="y", isotropic=True, device=None,
                 dtype=None):
        neg = dict(zmin=-_INF, zmax=-width, slope=0.0, x0=+1.0)
        mid = dict(zmin=-width, zmax=+width, slope=0.0, x0=-1.0)
        pos = dict(zmin=+width, zmax=_INF, slope=0.0, x0=+1.0)
        super().__init__("door", [pos, mid, neg], y, y_name, isotropic,
                         device, dtype)
        self.width = width
