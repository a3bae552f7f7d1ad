"""Exponential prior. Counterpart of tramp_tpu/priors/exponential_prior.py."""
import torch

from .base_prior import Prior
from ..beliefs import exponential, positive
from ..config import default_device, DEFAULT_DTYPE
from ..lanes import lane_mean
from ..utils.integration import exponential_measure, inner_gaussian_measure


class ExponentialPrior(Prior):
    r"""$p(x) = 1_+(x) \frac{1}{r} e^{-x/r}$. Reference
    exponential_prior.py:8-82.

    ``mean`` is a Python number, or one value per lane as a tensor
    ``(B, 1)``. ``device`` and ``dtype`` are those of the samples it draws
    (None: the defaults of tramp_tpu_torch.config)."""

    _data_fields = ("mean",)
    _meta_fields = ("size", "isotropic")
    device = None
    dtype = None

    def __init__(self, size, mean=1.0, isotropic=True, device=None,
                 dtype=None):
        super().__init__()
        self.size = size
        self.mean = mean
        self.isotropic = isotropic
        self.device = device
        self.dtype = dtype

    def math(self):
        return r"$\exp$"

    @property
    def b(self):
        return -1.0 / self.mean

    def _shape(self):
        return self.size if isinstance(self.size, tuple) else (self.size,)

    def out_shape(self):
        return self._shape()

    def sample(self, generator):
        x = torch.empty(self._shape(), device=self.device or default_device(),
                        dtype=self.dtype or DEFAULT_DTYPE)
        # the reference samples with scale=1/mean (exponential_prior.py:31),
        # inconsistent with its own second_moment; the JAX package keeps it
        return x.exponential_(generator=generator) / self.mean

    def second_moment(self):
        return 2.0 * self.mean**2

    def forward_second_moment_FG(self, tx_hat):
        return positive.tau(tx_hat, self.b + torch.zeros_like(tx_hat))

    def scalar_forward_mean(self, ax, bx):
        return positive.r(ax, bx + self.b)

    def scalar_forward_variance(self, ax, bx):
        return positive.v(ax, bx + self.b)

    def scalar_log_partition(self, ax, bx):
        return positive.A(ax, bx + self.b) - exponential.A(self.b)

    def compute_forward_posterior(self, ax, bx):
        b = bx + self.b
        rx = positive.r(ax, b)
        vx = positive.v(ax, b)
        if self.isotropic:
            vx = lane_mean(vx, ax)
        return rx, vx

    def compute_log_partition(self, ax, bx):
        return lane_mean(self.scalar_log_partition(ax, bx), ax)

    def _mean_like(self, like):
        "``mean`` as a tensor on ``like``'s device, per lane where it is."
        return self.mean + torch.zeros_like(like)

    def measure(self, f):
        zero = torch.zeros((), dtype=torch.float64,
                           device=self.device or default_device())
        return exponential_measure(self._mean_like(zero), f)

    def beliefs_measure(self, ax, f):
        """BO SE measure (NotImplemented in the reference,
        exponential_prior.py:60-76): bx = ax x* + sqrt(ax) xi with
        x* ~ Exp(mean); the exponential nodes (truncated at 10) and, inside,
        the standard-normal nodes."""
        def inner(x):
            return inner_gaussian_measure(ax * x, torch.sqrt(ax), f)

        return exponential_measure(self._mean_like(ax), inner)
