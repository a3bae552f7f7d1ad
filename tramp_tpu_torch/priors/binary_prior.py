"""Binary (+-1) prior. Counterpart of tramp_tpu/priors/binary_prior.py."""
import torch

from .base_prior import Prior
from ..beliefs import binary
from ..config import default_device, DEFAULT_DTYPE
from ..lanes import lane_mean, log
from ..utils.integration import gaussian_measure


class BinaryPrior(Prior):
    r"""$p(x) = p_+ \delta_+(x) + p_- \delta_-(x)$.
    Reference binary_prior.py:8-89.

    ``p_pos`` is a Python number, or one value per lane as a tensor
    ``(B, 1)`` (``lanes.stack_models``). ``device`` and ``dtype`` are those
    of the samples it draws (None: the defaults of tramp_tpu_torch.config)."""

    _data_fields = ("p_pos",)
    _meta_fields = ("size", "isotropic")
    device = None
    dtype = None

    def __init__(self, size, p_pos=0.5, isotropic=True, device=None,
                 dtype=None):
        super().__init__()
        self.size = size
        self.p_pos = p_pos
        self.isotropic = isotropic
        self.device = device
        self.dtype = dtype

    def math(self):
        return r"$p_\pm$"

    @property
    def p_neg(self):
        return 1.0 - self.p_pos

    @property
    def b(self):
        return 0.5 * log(self.p_pos / self.p_neg)

    def _shape(self):
        return self.size if isinstance(self.size, tuple) else (self.size,)

    def out_shape(self):
        return self._shape()

    def sample(self, generator):
        u = torch.rand(self._shape(), generator=generator,
                       device=self.device or default_device(),
                       dtype=self.dtype or DEFAULT_DTYPE)
        return torch.where(u < self.p_pos, 1.0, -1.0).to(u.dtype)

    def second_moment(self):
        return 1.0

    def forward_second_moment_FG(self, tx_hat):
        return binary.tau(self.b)

    def scalar_forward_mean(self, ax, bx):
        return binary.r(bx + self.b)

    def scalar_forward_variance(self, ax, bx):
        return binary.v(bx + self.b)

    def scalar_log_partition(self, ax, bx):
        return binary.A(bx + self.b) - binary.A(self.b) - 0.5 * ax

    def compute_forward_posterior(self, ax, bx):
        b = bx + self.b
        rx = binary.r(b)
        vx = binary.v(b)
        if self.isotropic:
            vx = lane_mean(vx, ax)
        return rx, vx

    def compute_log_partition(self, ax, bx):
        return lane_mean(self.scalar_log_partition(ax, bx), ax)

    def b_measure(self, mx_hat, qx_hat, tx0_hat, f):
        mu_pos = gaussian_measure(+mx_hat, torch.sqrt(qx_hat), f)
        mu_neg = gaussian_measure(-mx_hat, torch.sqrt(qx_hat), f)
        return self.p_pos * mu_pos + self.p_neg * mu_neg

    def bx_measure(self, mx_hat, qx_hat, tx0_hat, f):
        mu_pos = +gaussian_measure(+mx_hat, torch.sqrt(qx_hat), f)
        mu_neg = -gaussian_measure(-mx_hat, torch.sqrt(qx_hat), f)
        return self.p_pos * mu_pos + self.p_neg * mu_neg

    def beliefs_measure(self, ax, f):
        mu_pos = gaussian_measure(+ax, torch.sqrt(ax), f)
        mu_neg = gaussian_measure(-ax, torch.sqrt(ax), f)
        return self.p_pos * mu_pos + self.p_neg * mu_neg

    def measure(self, f):
        one = torch.ones((), dtype=torch.float64,
                         device=self.device or default_device())
        return self.p_pos * f(one) + self.p_neg * f(-one)
