"""MAP priors (L1 and L2,1 penalties) with soft-threshold proximal maps.
Counterpart of tramp_tpu/priors/map_priors.py.

MAP semantics: the 'variance' is the prox sensitivity 1/ax * d(prox)/db and
q_x = -2 dA/da replaces tau (docs/implementation.rst, section map_priors).
"""
import torch

from .base_prior import Prior
from ..config import default_device, DEFAULT_DTYPE
from ..lanes import lane_count, lane_mean


def soft_threshold(x, gamma):
    "Reference map_L1_norm_prior.py:11-13."
    return torch.clamp(1.0 - gamma / torch.abs(x), min=0.0) * x


def v_soft_threshold(x, gamma):
    "Reference map_L1_norm_prior.py:16-17."
    return (torch.abs(x) > gamma).to(x.dtype)


def group_soft_threshold(x, gamma, axis):
    "Reference map_L21_norm_prior.py:12-14."
    x_norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return torch.clamp(1.0 - gamma / x_norm, min=0.0) * x


def v_group_soft_threshold(x, gamma, axis):
    "Reference map_L21_norm_prior.py:17-20."
    x_norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return (x_norm > gamma) * (
        1.0 + (x**2 / x_norm**2 - 1.0) * gamma / x_norm)


class MAP_L1NormPrior(Prior):
    r"""MAP prior for the L1 penalty $f(x)=e^{-\gamma \|x\|_1}$.
    Reference map_L1_norm_prior.py:20-88. ``gamma`` is a Python number, or
    one value per lane as a tensor ``(B, 1)``."""

    _data_fields = ("gamma",)
    _meta_fields = ("size", "isotropic")
    device = None
    dtype = None

    def __init__(self, size, gamma=1.0, isotropic=True, device=None,
                 dtype=None):
        super().__init__()
        self.size = size
        self.gamma = gamma
        self.isotropic = isotropic
        self.device = device
        self.dtype = dtype

    def math(self):
        return r"$\Vert.\Vert_1$"

    def _shape(self):
        return self.size if isinstance(self.size, tuple) else (self.size,)

    def out_shape(self):
        return self._shape()

    def sample(self, generator):
        kw = dict(generator=generator, device=self.device or default_device(),
                  dtype=self.dtype or DEFAULT_DTYPE)
        # a standard Laplace draw: an exponential with a random sign
        magnitude = torch.empty(self._shape(), device=kw["device"],
                                dtype=kw["dtype"]).exponential_(
                                    generator=generator)
        sign = torch.where(torch.rand(self._shape(), **kw) < 0.5, -1.0, 1.0)
        return sign.to(magnitude.dtype) * magnitude / self.gamma

    def scalar_forward_mean(self, ax, bx):
        return (1.0 / ax) * soft_threshold(bx, self.gamma)

    def scalar_forward_variance(self, ax, bx):
        return (1.0 / ax) * v_soft_threshold(bx, self.gamma)

    def scalar_log_partition(self, ax, bx):
        rx = (1.0 / ax) * soft_threshold(bx, self.gamma)
        return bx * rx - 0.5 * ax * rx**2 - self.gamma * torch.abs(rx)

    def compute_forward_posterior(self, ax, bx):
        rx = (1.0 / ax) * soft_threshold(bx, self.gamma)
        vx = (1.0 / ax) * v_soft_threshold(bx, self.gamma)
        if self.isotropic:
            vx = lane_mean(vx, ax)
        return rx, vx

    def compute_log_partition(self, ax, bx):
        return lane_mean(self.scalar_log_partition(ax, bx), ax)


class MAP_L21NormPrior(Prior):
    r"""MAP prior for the L2,1 penalty $f(x)=e^{-\gamma \|x\|_{2,1}}$,
    group norm over ``axis`` of the variable. Reference
    map_L21_norm_prior.py:23-89. With lanes (told by the precision ``ax``,
    ``lanes.lane_count``) the variable's axes follow the lane axis."""

    _data_fields = ("gamma",)
    _meta_fields = ("size", "axis", "isotropic")
    device = None
    dtype = None

    def __init__(self, size, gamma=1.0, axis=0, isotropic=True, device=None,
                 dtype=None):
        if not (isinstance(size, tuple) and len(size) > 1):
            raise ValueError("size must be a tuple of length > 1")
        super().__init__()
        self.size = size
        self.gamma = gamma
        self.axis = axis
        self.isotropic = isotropic
        self.device = device
        self.dtype = dtype

    def math(self):
        return r"$\Vert.\Vert_{2,1}$"

    def out_shape(self):
        return self.size

    def sample(self, generator):
        # the reference returns zeros as a placeholder
        # (map_L21_norm_prior.py:55-60)
        return torch.zeros(self.size, device=self.device or default_device(),
                           dtype=self.dtype or DEFAULT_DTYPE)

    def _axis(self, ax, bx):
        "The group axis of ``bx``: one further along with lanes."
        lanes = lane_count(ax, bx) is not None
        return self.axis + 1 if lanes and self.axis >= 0 else self.axis

    def compute_forward_posterior(self, ax, bx):
        axis = self._axis(ax, bx)
        rx = (1.0 / ax) * group_soft_threshold(bx, self.gamma, axis)
        vx = (1.0 / ax) * v_group_soft_threshold(bx, self.gamma, axis)
        if self.isotropic:
            vx = lane_mean(vx, ax)
        return rx, vx

    def compute_log_partition(self, ax, bx):
        axis = self._axis(ax, bx)
        rx = (1.0 / ax) * group_soft_threshold(bx, self.gamma, axis)
        norms = torch.linalg.vector_norm(rx, dim=axis, keepdim=True)
        # the mean over the variable's elements of bx rx - ax rx^2 / 2, less
        # gamma times the sum of the group norms over the elements
        N = 1
        for s in self.size:
            N *= s
        if lane_count(ax, bx) is None:
            return (torch.sum(bx * rx - 0.5 * ax * rx**2)
                    - self.gamma * torch.sum(norms)) / N
        dims = tuple(range(1, bx.ndim))
        return (torch.sum(bx * rx - 0.5 * ax * rx**2, dim=dims, keepdim=True)
                - self.gamma * torch.sum(norms, dim=dims, keepdim=True)) / N
