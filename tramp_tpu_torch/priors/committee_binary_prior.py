"""Committee binary prior: K coupled +-1 spins per component, exact
enumeration over 2^K configurations. Counterpart of
tramp_tpu/priors/committee_binary_prior.py.

One instance only: its precision is a K x K matrix per component, which is
not one value per lane (tramp_tpu_torch/lanes.py). Lanes raise here: the
committee models do not use this prior, and its lanes wait for the engine
extras (ROADMAP Queue 1 item 7)."""
import numpy as np
import torch

from .base_prior import Prior
from ..beliefs import binary
from ..config import default_device, DEFAULT_DTYPE
from ..lanes import log


def create_spins(K):
    "All 2^K spin configurations, shape (2^K, K). Reference l:9-13."
    x = ((np.arange(2**K)[:, None] >> np.arange(K - 1, -1, -1)[None, :]) & 1)
    return 2 * x - 1


class CommitteeBinaryPrior(Prior):
    r"""Binary prior over x of shape (N, K): K coupled spins with full KxK
    precision coupling ax. Reference committee_binary_prior.py:117-201.
    ``device`` and ``dtype`` are those of the samples it draws (None: the
    defaults of tramp_tpu_torch.config)."""

    _data_fields = ("p_pos",)
    _meta_fields = ("N", "K", "size")
    device = None
    dtype = None

    def __init__(self, N, K, p_pos=0.5, device=None, dtype=None):
        super().__init__()
        self.N = N
        self.K = K
        self.p_pos = p_pos
        self.size = (N, K)
        self.device = device
        self.dtype = dtype

    @property
    def p_neg(self):
        return 1.0 - self.p_pos

    @property
    def b(self):
        return 0.5 * log(self.p_pos / self.p_neg)

    def spins(self, like):
        "The (2^K, K) spin configurations on ``like``'s device and dtype."
        return torch.as_tensor(create_spins(self.K), dtype=like.dtype,
                               device=like.device)

    def out_shape(self):
        return self.size

    def _one_instance(self, ax, bx):
        if (isinstance(self.p_pos, torch.Tensor) or ax.ndim > 2
                or bx.ndim > 2):
            raise ValueError(
                "CommitteeBinaryPrior takes one instance: its precision is a "
                "K x K matrix, not one value per lane; its lanes wait for "
                "ROADMAP Queue 1 item 7")

    def sample(self, generator):
        u = torch.rand(self.size, generator=generator,
                       device=self.device or default_device(),
                       dtype=self.dtype or DEFAULT_DTYPE)
        return torch.where(u < self.p_pos, 1.0, -1.0).to(u.dtype)

    def second_moment(self):
        return 1.0

    def _Ax(self, ax, b):
        """Ax_.c = -1/2 x_c.ax.x_c + b.x_c with x_c the spin configs.
        ax is (K, K), b is (..., K). Reference l:37-76."""
        self._one_instance(ax, b)
        x = self.spins(b)  # (C, K)
        xax = torch.einsum("ck,kl,cl->c", x, ax, x)
        bx = torch.einsum("...k,ck->...c", b, x)
        return -0.5 * xax + bx

    def scalar_forward_mean(self, ax, bx):
        prob = torch.softmax(self._Ax(ax, bx + self.b), dim=-1)
        return prob @ self.spins(bx)

    def scalar_forward_variance(self, ax, bx):
        x = self.spins(bx)
        prob = torch.softmax(self._Ax(ax, bx + self.b), dim=-1)
        m = prob @ x  # (K,)
        xx = torch.einsum("c,ck,cl->kl", prob, x, x)
        # V = sum_cd p_c p_d (x_c - x_d)(x_c - x_d)^T = 2 (E[xx^T] - m m^T)
        return 2.0 * (xx - torch.outer(m, m))

    def scalar_log_partition(self, ax, bx):
        Ax = self._Ax(ax, bx + self.b)
        return torch.logsumexp(Ax, dim=-1) / self.K - binary.A(self.b)

    def compute_forward_posterior(self, ax, bx):
        x = self.spins(bx)
        prob = torch.softmax(self._Ax(ax, bx + self.b), dim=-1)  # (N, C)
        rx = prob @ x  # (N, K)
        # V_kl = (1/N) sum_i sum_cd p_ic p_id C_cdkl
        #      = (2/N) sum_i (E_i[xx^T] - m_i m_i^T)
        xx = torch.einsum("ic,ck,cl->kl", prob, x, x) / self.N
        mm = torch.einsum("ik,il->kl", rx, rx) / self.N
        vx = 2.0 * (xx - mm)
        return rx, vx

    def compute_log_partition(self, ax, bx):
        Ax = self._Ax(ax, bx + self.b)
        return torch.mean(torch.logsumexp(Ax, dim=-1)) - binary.A(self.b)

    def measure(self, f):
        one = torch.ones((), dtype=torch.float64,
                         device=self.device or default_device())
        return self.p_pos * f(one) + self.p_neg * f(-one)
