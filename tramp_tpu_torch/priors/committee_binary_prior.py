"""Committee binary prior: K coupled +-1 spins per component, exact
enumeration over 2^K configurations. Counterpart of
tramp_tpu/priors/committee_binary_prior.py.

Lanes: the denoiser takes a first lane axis, the JAX denoiser under
``jax.vmap``. Its precision is a K x K matrix, so a lane's precision is
``(B, K, K)`` (not the ``(B, 1)`` of tramp_tpu_torch/lanes.py), with ``bx``
``(B, N, K)`` (``(B, K)`` in the ``scalar_*`` methods) and ``p_pos`` a
number or one value per lane ``(B, 1)``. The EP engine passes one number
as the precision, so EP on a model with this prior raises, as in the JAX
package."""
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

    def math(self):
        return r"$p_\pm$"

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

    def _lanes(self, ax):
        "B when the precision or p_pos carries a lane axis, else None."
        if ax.ndim == 3:
            return ax.shape[0]
        if isinstance(self.p_pos, torch.Tensor) and self.p_pos.ndim:
            return self.p_pos.shape[0]
        return None

    def _bias(self, bx, lanes):
        "The field b of p_pos, shaped to add to ``bx``."
        b = self.b
        if lanes is not None and isinstance(b, torch.Tensor) and b.ndim:
            b = b.reshape((lanes,) + (1,) * (bx.ndim - 1))
        return b

    def _A_b(self, lanes):
        "binary.A of the field: a number, or ``(B,)`` with lanes."
        A = binary.A(self.b)
        if lanes is not None and isinstance(A, torch.Tensor) and A.ndim:
            A = A.reshape(lanes)
        return A

    def sample(self, generator):
        u = torch.rand(self.size, generator=generator,
                       device=self.device or default_device(),
                       dtype=self.dtype or DEFAULT_DTYPE)
        return torch.where(u < self.p_pos, 1.0, -1.0).to(u.dtype)

    def second_moment(self):
        return 1.0

    def _Ax(self, ax, bx):
        """Ax_.c = -1/2 x_c.ax.x_c + b.x_c with x_c the spin configs and b
        the field bx plus that of p_pos. ax is (K, K) or (B, K, K), bx is
        (..., K) or (B, ..., K). Reference l:37-76."""
        if ax.ndim not in (2, 3) or tuple(ax.shape[-2:]) != (self.K,) * 2:
            raise ValueError(
                f"CommitteeBinaryPrior takes a K x K precision (K={self.K}), "
                f"one per lane with lanes; got shape {tuple(ax.shape)}")
        lanes = self._lanes(ax)
        b = bx + self._bias(bx, lanes)
        x = self.spins(b)  # (C, K)
        xax = torch.einsum("ck,...kl,cl->...c", x, ax, x)
        if lanes is not None and ax.ndim == 3:
            xax = xax.reshape((lanes,) + (1,) * (b.ndim - 2) + (-1,))
        return -0.5 * xax + torch.einsum("...k,ck->...c", b, x)

    def scalar_forward_mean(self, ax, bx):
        prob = torch.softmax(self._Ax(ax, bx), dim=-1)
        return prob @ self.spins(bx)

    def scalar_forward_variance(self, ax, bx):
        x = self.spins(bx)
        prob = torch.softmax(self._Ax(ax, bx), dim=-1)
        m = prob @ x  # (..., K)
        xx = torch.einsum("...c,ck,cl->...kl", prob, x, x)
        # V = sum_cd p_c p_d (x_c - x_d)(x_c - x_d)^T = 2 (E[xx^T] - m m^T)
        return 2.0 * (xx - m[..., :, None] * m[..., None, :])

    def scalar_log_partition(self, ax, bx):
        return (torch.logsumexp(self._Ax(ax, bx), dim=-1) / self.K
                - self._A_b(self._lanes(ax)))

    def compute_forward_posterior(self, ax, bx):
        x = self.spins(bx)
        prob = torch.softmax(self._Ax(ax, bx), dim=-1)  # (..., N, C)
        rx = prob @ x  # (..., N, K)
        # V_kl = (1/N) sum_i sum_cd p_ic p_id C_cdkl
        #      = (2/N) sum_i (E_i[xx^T] - m_i m_i^T)
        xx = torch.einsum("...ic,ck,cl->...kl", prob, x, x) / self.N
        mm = torch.einsum("...ik,...il->...kl", rx, rx) / self.N
        vx = 2.0 * (xx - mm)
        return rx, vx

    def compute_log_partition(self, ax, bx):
        Ax = self._Ax(ax, bx)
        return (torch.logsumexp(Ax, dim=-1).mean(-1)
                - self._A_b(self._lanes(ax)))

    def measure(self, f):
        one = torch.ones((), dtype=torch.float64,
                         device=self.device or default_device())
        return self.p_pos * f(one) + self.p_neg * f(-one)
