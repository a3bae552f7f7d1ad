"""One linear piece x = x0 + slope*z, z in [zmin, zmax], of a
piecewise-linear channel. Counterpart of tramp_tpu/utils/linear_region.py.
All region parameters are Python floats.

The moments and log-partitions of all regions of a channel are computed
together by tramp_tpu_torch/ops/pl_fused.py; the per-region methods here are
their region-by-region form (the reference's), which the tests hold the
fused form against. What the state evolution needs of a region alone is its
second moment, its probabilities and its measure over (bz, bx)."""
import torch

from .integration import _total, grid_2d, grid_2d_full
from .truncated_normal import (
    truncated_normal_mean, truncated_normal_var, truncated_normal_logZ,
    truncated_normal_proba,
)


class LinearRegion:

    def __init__(self, zmin, zmax, x0, slope):
        if not zmin < zmax:
            raise ValueError(f"need zmin < zmax, got [{zmin}, {zmax}]")
        self.zmin = zmin
        self.zmax = zmax
        self.x0 = x0
        self.slope = slope

    def __repr__(self):
        return (f"LinearRegion(zmin={self.zmin}, zmax={self.zmax}, "
                f"x0={self.x0}, slope={self.slope})")

    def x(self, z):
        return self.x0 + self.slope * z

    def sample(self, Z):
        return self.x(Z) * (self.zmin <= Z) * (Z < self.zmax)

    def get_r0_v0(self, az, bz, ax, bx):
        a = az + self.slope**2 * ax
        b = bz + self.slope * (bx - ax * self.x0)
        return b / a, 1.0 / a

    def backward_mean(self, az, bz, ax, bx):
        r0, v0 = self.get_r0_v0(az, bz, ax, bx)
        return truncated_normal_mean(r0, v0, self.zmin, self.zmax)

    def backward_variance(self, az, bz, ax, bx):
        r0, v0 = self.get_r0_v0(az, bz, ax, bx)
        return truncated_normal_var(r0, v0, self.zmin, self.zmax)

    def forward_mean(self, az, bz, ax, bx):
        return self.slope * self.backward_mean(az, bz, ax, bx) + self.x0

    def forward_variance(self, az, bz, ax, bx):
        return self.slope**2 * self.backward_variance(az, bz, ax, bx)

    def log_partitions(self, az, bz, ax, bx):
        "Element-wise log partition. Reference linear_region.py:59-65."
        r0, v0 = self.get_r0_v0(az, bz, ax, bx)
        trunc_logZ = truncated_normal_logZ(r0, v0, self.zmin, self.zmax)
        return trunc_logZ - 0.5 * ax * self.x0**2 + bx * self.x0

    def second_moment(self, tau_z):
        # a Python number (a prior's second moment) becomes a float64 scalar
        tau_z = torch.as_tensor(tau_z, dtype=None if isinstance(
            tau_z, torch.Tensor) else torch.float64)
        zero = torch.zeros_like(tau_z)
        rz = truncated_normal_mean(zero, tau_z, self.zmin, self.zmax)
        vz = truncated_normal_var(zero, tau_z, self.zmin, self.zmax)
        rx = self.slope * rz + self.x0
        vx = self.slope**2 * vz
        return rx**2 + vx

    def proba_tau(self, tau_z):
        tau_z = torch.as_tensor(tau_z, dtype=None if isinstance(
            tau_z, torch.Tensor) else torch.float64)
        return truncated_normal_proba(torch.zeros_like(tau_z), tau_z,
                                      self.zmin, self.zmax)

    def proba_ab(self, az, bz, ax, bx):
        r0, v0 = self.get_r0_v0(az, bz, ax, bx)
        return truncated_normal_proba(r0, v0, self.zmin, self.zmax)

    def beliefs_grid(self, az, ax, tau_z):
        """Nodes (bz, bx) and weights of this region's SE measure over
        (bz, bx), flattened (utils/integration.py): the measure of f is
        ``sum(weights * f(bz, bx))`` over the last axis. The weights hold the
        quadrature's and the region's probability ``proba_ab`` at the nodes.
        Reference linear_region.py:82-103."""
        u_eff = torch.clamp(az * tau_z - 1.0, min=0.0)
        mean_x = ax * self.x0
        if self.slope == 0:
            sz_eff = torch.sqrt(az * u_eff)
            sx_eff = torch.sqrt(ax * (self.slope**2 * ax * tau_z + 1.0))
            bz, bx, w = grid_2d(0.0, sz_eff, mean_x, sx_eff)
        else:
            # full covariance; degenerate cases (ax=0 or u_eff=0) handled
            # by jitter on the diagonal
            eps = 1e-12
            cov_zz = az * u_eff + eps
            cov_zx = self.slope * ax * u_eff
            cov_xx = ax * (self.slope**2 * ax * tau_z + 1.0) + eps
            bz, bx, w = grid_2d_full(
                (0.0, mean_x), ((cov_zz, cov_zx), (cov_zx, cov_xx)))
        return bz, bx, w * self.proba_ab(az, bz, ax, bx)

    def beliefs_measure(self, az, ax, tau_z, f):
        "SE measure of f over (bz, bx): one region's term of the channel's."
        bz, bx, w = self.beliefs_grid(az, ax, tau_z)
        return _total(w * f(bz, bx), az.ndim > 0)
