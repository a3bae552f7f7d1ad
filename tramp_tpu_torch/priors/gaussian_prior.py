"""Gaussian prior. Counterpart of tramp_tpu/priors/gaussian_prior.py."""
import torch

from .base_prior import Prior
from ..beliefs import normal
from ..config import default_device, DEFAULT_DTYPE
from ..lanes import lane_mean, sqrt
from ..utils.integration import gaussian_measure


class GaussianPrior(Prior):
    r"""Gaussian prior $p(x)=\mathcal{N}(x|mean, var)$ over an array of
    shape ``size``. Reference tramp/priors/gaussian_prior.py:8-143.

    ``mean`` and ``var`` are Python numbers, or one value per lane as
    tensors ``(B, 1)``. ``device`` and ``dtype`` are those of the samples
    and constant messages (None: the defaults of tramp_tpu_torch.config)."""

    _data_fields = ("mean", "var")
    _meta_fields = ("size", "isotropic")
    device = None
    dtype = None

    def __init__(self, size, mean=0.0, var=1.0, isotropic=True, device=None,
                 dtype=None):
        super().__init__()
        self.size = size
        self.mean = mean
        self.var = var
        self.isotropic = isotropic
        self.device = device
        self.dtype = dtype

    def math(self):
        return r"$\mathcal{N}$"

    @property
    def a(self):
        return 1.0 / self.var

    @property
    def b(self):
        return self.mean / self.var

    def _shape(self):
        return self.size if isinstance(self.size, tuple) else (self.size,)

    def out_shape(self):
        return self._shape()

    def sample(self, generator):
        x = torch.randn(self._shape(), generator=generator,
                        device=self.device or default_device(),
                        dtype=self.dtype or DEFAULT_DTYPE)
        return self.mean + sqrt(self.var) * x

    def second_moment(self):
        return self.mean**2 + self.var

    def forward_second_moment_FG(self, tx_hat):
        return normal.tau(tx_hat + self.a, self.b)

    def scalar_forward_mean(self, ax, bx):
        return (bx + self.b) / (ax + self.a)

    def scalar_forward_variance(self, ax, bx):
        return 1.0 / (ax + self.a)

    def scalar_log_partition(self, ax, bx):
        at, bt = (torch.as_tensor(v, dtype=bx.dtype, device=bx.device)
                  for v in (self.a, self.b))
        return normal.A(ax + at, bx + bt) - normal.A(at, bt)

    def compute_forward_posterior(self, ax, bx):
        a = ax + self.a
        b = bx + self.b
        return b / a, 1.0 / a

    def compute_log_partition(self, ax, bx):
        return lane_mean(self.scalar_log_partition(ax, bx), ax)

    def compute_forward_error(self, ax):
        return 1.0 / (ax + self.a)

    def compute_forward_v_BO(self, ax, tx0_hat):
        return 1.0 / (ax + self.a)

    def compute_forward_message(self, ax, bx):
        "Fast path: the outgoing message is constant (reference l:86-89)."
        return self.a * torch.ones_like(ax), self.b * torch.ones_like(bx)

    def constant_forward_message(self):
        """The message as a model constant: a = 1/var, b = mean/var broadcast
        to the variable's shape."""
        kw = dict(device=self.device or default_device(),
                  dtype=self.dtype or DEFAULT_DTYPE)
        return {"a": torch.as_tensor(self.a, **kw),
                "b": torch.broadcast_to(torch.as_tensor(self.b, **kw),
                                        self._shape())}

    def compute_forward_state_evolution(self, ax):
        return self.a * torch.ones_like(ax)

    def compute_forward_state_evolution_BO(self, ax, tx0_hat):
        return self.a * torch.ones_like(ax)

    def b_measure(self, mx_hat, qx_hat, tx0_hat, f):
        a0 = self.a + tx0_hat
        r0 = self.b / a0
        v0 = 1.0 / a0
        return gaussian_measure(
            mx_hat * r0, torch.sqrt(qx_hat + mx_hat**2 * v0), f)

    def bx_measure(self, mx_hat, qx_hat, tx0_hat, f):
        a0 = self.a + tx0_hat
        r0 = self.b / a0
        v0 = 1.0 / a0
        ax_star = mx_hat**2 / qx_hat

        def r_times_f(bx):
            bx_star = (mx_hat / qx_hat) * bx
            return (self.b + bx_star) / (a0 + ax_star) * f(bx)

        return gaussian_measure(
            mx_hat * r0, torch.sqrt(qx_hat + mx_hat**2 * v0), r_times_f)

    def beliefs_measure(self, ax, f):
        return gaussian_measure(
            ax * self.mean, torch.sqrt(ax + ax**2 * self.var), f)

    def measure(self, f):
        mean = torch.as_tensor(self.mean, dtype=torch.float64,
                               device=self.device or default_device())
        return gaussian_measure(mean, sqrt(self.var), f)

    def compute_mutual_information(self, ax):
        return 0.5 * torch.log((ax + self.a) * self.var)

    def compute_free_energy(self, ax):
        tau_x = self.second_moment()
        return 0.5 * ax * tau_x - self.compute_mutual_information(ax)
