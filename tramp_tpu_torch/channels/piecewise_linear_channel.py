"""The generic nonlinearity engine: activations as mixtures of linear
regions, merged by a softmax over per-region log partitions.
Counterpart of tramp_tpu/channels/piecewise_linear_channel.py (EP part).

Both EP posteriors go through one fused call, ``ops.pl_posterior``: the
hand-written CUDA kernel on a GPU, its plain twin on the CPU."""
import math

import torch

from .base_channel import Channel
from ..ops import pl_posterior
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

    @property
    def regions(self):
        return [LinearRegion(zmin=zmin, zmax=zmax, x0=x0, slope=slope)
                for (zmin, zmax, x0, slope) in self.region_specs]

    def sample(self, generator, Z):
        return sum(region.sample(Z) for region in self.regions)

    def compute_forward_posterior(self, az, bz, ax, bx):
        _, _, rx, vx, _ = pl_posterior(az, bz, ax, bx, self.region_specs)
        return rx, torch.mean(vx)

    def compute_backward_posterior(self, az, bz, ax, bx):
        rz, vz, _, _, _ = pl_posterior(az, bz, ax, bx, self.region_specs)
        return rz, torch.mean(vz)


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
