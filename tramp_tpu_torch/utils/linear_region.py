"""One linear piece x = x0 + slope*z, z in [zmin, zmax], of a
piecewise-linear channel. Counterpart of tramp_tpu/utils/linear_region.py;
the EP moments of all regions are computed together by
tramp_tpu_torch/ops/pl_fused.py, so only sampling lives here."""


class LinearRegion:

    def __init__(self, zmin, zmax, x0, slope):
        if not zmin < zmax:
            raise ValueError(f"need zmin < zmax, got [{zmin}, {zmax}]")
        self.zmin = zmin
        self.zmax = zmax
        self.x0 = x0
        self.slope = slope

    def x(self, z):
        return self.x0 + self.slope * z

    def sample(self, Z):
        return self.x(Z) * (self.zmin <= Z) * (Z < self.zmax)
