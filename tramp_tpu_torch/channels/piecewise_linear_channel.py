"""The generic nonlinearity engine: activations as mixtures of linear
regions, merged by a softmax over per-region log partitions.
Counterpart of tramp_tpu/channels/piecewise_linear_channel.py.

The EP messages are one fused call each, ``ops.pl_forward_message`` and
``ops.pl_backward_message`` (posterior of one side, mean of its variance
and the moment-matching update); the posteriors go through the five-output
``ops.pl_posterior``, and so do the elementwise integrands of the state
evolution (``scalar_*``): its outputs vx, vz and logZ on the quadrature
grid of (bz, bx). Each is a hand-written CUDA kernel on a GPU and its plain
twin on the CPU.

The SE measure of the channel is the sum of its regions' measures
(utils/linear_region.py). ``beliefs_measure`` lays the K regions' grids end
to end along the node axis and calls the integrand once on all of them, so
an error or a free energy is one launch of ``pl_posterior`` whatever K, and
one sweep of the state evolution, a forward and a backward error, is two.
The measure adds its lanes x nodes to ``integration.nodes_evaluated`` and
runs in the span ``se.channel_measure`` (``trace``)."""
import math

import torch

from .base_channel import Channel
from .. import trace
from ..lanes import lane_count, lane_mean, per_lane
from ..ops import pl_posterior, pl_forward_message, pl_backward_message
from ..utils.integration import _total
from ..utils.linear_region import LinearRegion

_INF = math.inf


class PiecewiseLinearChannel(Channel):

    _data_fields = ()
    _meta_fields = ("name", "region_specs")

    def __init__(self, name, regions):
        super().__init__()
        self.name = name
        self.region_specs = tuple(
            (r["zmin"], r["zmax"], r["x0"], r["slope"]) for r in regions)

    def math(self):
        return rf"$\mathrm{{{self.name}}}$"

    @property
    def regions(self):
        return [LinearRegion(zmin=zmin, zmax=zmax, x0=x0, slope=slope)
                for (zmin, zmax, x0, slope) in self.region_specs]

    def sample(self, generator, Z):
        return sum(region.sample(Z) for region in self.regions)

    @property
    def n_regions(self):
        return len(self.region_specs)

    def second_moment(self, tau_z):
        return sum(region.proba_tau(tau_z) * region.second_moment(tau_z)
                   for region in self.regions)

    @staticmethod
    def _merge_elementwise(rs, vs, As):
        """Softmax-weighted mixture of the regions' moments (lists, one
        tensor per region), no isotropic mean."""
        As, rs, vs = (torch.stack(list(t), 0) for t in (As, rs, vs))
        ps = torch.softmax(As, dim=0)
        r = torch.sum(ps * rs, 0)
        # cross-region variance sum_{i<j} p_i p_j (r_i - r_j)^2
        #   = E[r^2] - E[r]^2 over the region weights
        v = torch.sum(ps * vs, 0) + torch.sum(ps * rs**2, 0) - r**2
        return r, v

    def merge_estimates(self, rs, vs, As):
        """Merged posterior with isotropic variance (reference l:27-37):
        the regions' means ``rs``, variances ``vs`` and log-partitions
        ``As``, one tensor per region. The sweeps merge inside the kernels
        (``ops.pl_fused``)."""
        r, v = self._merge_elementwise(rs, vs, As)
        return r, torch.mean(v)

    # elementwise SE integrands (see Channel.scalar_* in base_channel.py):
    # outputs of the five-output posterior, no isotropic mean
    def scalar_forward_variance(self, az, bz, ax, bx):
        return pl_posterior(az, bz, ax, bx, self.region_specs)[3]

    def scalar_backward_variance(self, az, bz, ax, bx):
        return pl_posterior(az, bz, ax, bx, self.region_specs)[1]

    def scalar_log_partition(self, az, bz, ax, bx):
        return pl_posterior(az, bz, ax, bx, self.region_specs)[4]

    def compute_log_partition(self, az, bz, ax, bx):
        logZ = self.scalar_log_partition(az, bz, ax, bx)
        if lane_count(az, bz) is None and lane_count(ax, bz) is None:
            return torch.sum(logZ)
        return per_lane(logZ, True).sum(-1)

    def beliefs_measure(self, az, ax, tau_z, f):
        """SE measure of f over (bz, bx): the K regions' grids
        (``LinearRegion.beliefs_grid``) end to end, one call of ``f``."""
        with trace.span("se.channel_measure"):
            grids = [region.beliefs_grid(az, ax, tau_z)
                     for region in self.regions]
            bz, bx, w = (torch.cat([g[i] for g in grids], -1).contiguous()
                         for i in range(3))
            return _total(w * f(bz, bx), az.ndim > 0)

    def compute_forward_posterior(self, az, bz, ax, bx):
        _, _, rx, vx, _ = pl_posterior(az, bz, ax, bx, self.region_specs)
        return rx, lane_mean(vx, az, ax)

    def compute_backward_posterior(self, az, bz, ax, bx):
        rz, vz, _, _, _ = pl_posterior(az, bz, ax, bx, self.region_specs)
        return rz, lane_mean(vz, az, ax)

    def compute_forward_message(self, az, bz, ax, bx):
        return pl_forward_message(az, bz, ax, bx, self.region_specs)

    def compute_backward_message(self, az, bz, ax, bx):
        return pl_backward_message(az, bz, ax, bx, self.region_specs)


class LeakyReluChannel(PiecewiseLinearChannel):
    _meta_fields = ("name", "region_specs", "slope")

    def __init__(self, slope):
        neg = dict(zmin=-_INF, zmax=0.0, slope=slope, x0=0.0)
        pos = dict(zmin=0.0, zmax=_INF, slope=1.0, x0=0.0)
        super().__init__(name="l-relu", regions=[pos, neg])
        self.slope = slope


class SgnChannel(PiecewiseLinearChannel):
    def __init__(self):
        neg = dict(zmin=-_INF, zmax=0.0, slope=0.0, x0=-1.0)
        pos = dict(zmin=0.0, zmax=_INF, slope=0.0, x0=+1.0)
        super().__init__(name="sgn", regions=[pos, neg])


class AbsChannel(PiecewiseLinearChannel):
    def __init__(self):
        neg = dict(zmin=-_INF, zmax=0.0, slope=-1.0, x0=0.0)
        pos = dict(zmin=0.0, zmax=_INF, slope=+1.0, x0=0.0)
        super().__init__(name="abs", regions=[pos, neg])


class AsymmetricAbsChannel(PiecewiseLinearChannel):
    _meta_fields = ("name", "region_specs", "shift")

    def __init__(self, shift=1e-4):
        neg = dict(zmin=-_INF, zmax=shift, slope=-1.0, x0=0.0)
        pos = dict(zmin=shift, zmax=_INF, slope=+1.0, x0=0.0)
        super().__init__(name="a-abs", regions=[pos, neg])
        self.shift = shift


class ReluChannel(PiecewiseLinearChannel):
    def __init__(self):
        neg = dict(zmin=-_INF, zmax=0.0, slope=0.0, x0=0.0)
        pos = dict(zmin=0.0, zmax=_INF, slope=1.0, x0=0.0)
        super().__init__(name="relu", regions=[pos, neg])


class HardTanhChannel(PiecewiseLinearChannel):
    def __init__(self):
        neg = dict(zmin=-_INF, zmax=-1.0, slope=0.0, x0=-1.0)
        mid = dict(zmin=-1.0, zmax=+1.0, slope=1.0, x0=0.0)
        pos = dict(zmin=1.0, zmax=_INF, slope=0.0, x0=1.0)
        super().__init__(name="h-tanh", regions=[pos, mid, neg])


class HardSigmoidChannel(PiecewiseLinearChannel):
    def __init__(self):
        L = 2.5
        neg = dict(zmin=-_INF, zmax=-L, slope=0.0, x0=0.0)
        mid = dict(zmin=-L, zmax=+L, slope=1.0 / (2 * L), x0=0.5)
        pos = dict(zmin=L, zmax=_INF, slope=0.0, x0=1.0)
        super().__init__(name="h-sigm", regions=[pos, mid, neg])


class SymmetricDoorChannel(PiecewiseLinearChannel):
    _meta_fields = ("name", "region_specs", "width")

    def __init__(self, width):
        neg = dict(zmin=-_INF, zmax=-width, slope=0.0, x0=+1.0)
        mid = dict(zmin=-width, zmax=+width, slope=0.0, x0=-1.0)
        pos = dict(zmin=+width, zmax=_INF, slope=0.0, x0=+1.0)
        super().__init__(name="door", regions=[pos, mid, neg])
        self.width = width
