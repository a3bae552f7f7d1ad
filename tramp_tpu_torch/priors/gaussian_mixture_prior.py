"""Gaussian mixture prior. Counterpart of
tramp_tpu/priors/gaussian_mixture_prior.py."""
import numpy as np
import torch

from .base_prior import Prior
from ..beliefs import normal, mixture
from ..config import as_tensor
from ..lanes import lane_mean
from ..utils.integration import gaussian_measure


class GaussianMixturePrior(Prior):
    r"""$p(x)=\sum_{k=1}^K p_k \mathcal{N}(x|r_k,v_k)$.
    Reference gaussian_mixture_prior.py:8-139.

    The component parameters ``probs``, ``means`` and ``vars`` are buffers
    of shape ``(K,)``, on ``device`` with ``dtype`` (None: the defaults of
    tramp_tpu_torch.config). With lanes they are ``(B, K)``, one row per
    lane, the component axis last (``lanes.stack_models`` stacks them). The
    beliefs take the components on a leading axis: ``_components`` moves
    them there, before the lane axis, ``(K, B, 1, ...)``."""

    _data_fields = ("probs", "means", "vars")
    _meta_fields = ("size", "isotropic", "K")

    def __init__(self, size, probs=(0.5, 0.5), means=(-1.0, 1.0),
                 vars=(1.0, 1.0), isotropic=True, device=None, dtype=None):
        super().__init__()
        if not len(probs) == len(means) == len(vars):
            raise ValueError("probs, means and vars differ in length")
        self.size = size
        self.K = len(probs)
        self.isotropic = isotropic
        for name, value in (("probs", probs), ("means", means),
                            ("vars", vars)):
            self.register_buffer(name, as_tensor(
                np.asarray(value, dtype=np.float64), device, dtype))

    def math(self):
        return r"$\mathrm{GMM}$"

    def _lanes(self):
        return self.probs.ndim == 2

    def _components(self, like_ndim=0):
        """(probs, means, vars, a, b, eta), the component axis first: shape
        ``(K,)`` followed by ``like_ndim`` axes of length 1 without lanes,
        ``(K, B)`` followed by ``like_ndim - 1`` of them with lanes, so that
        they broadcast against an array of ``like_ndim`` axes (a node or
        message array, lanes first)."""
        out = []
        for x in (self.probs, self.means, self.vars):
            if self._lanes():
                x = x.T.reshape(x.shape[::-1] + (1,) * (like_ndim - 1))
            else:
                x = x.reshape(x.shape + (1,) * like_ndim)
            out.append(x)
        probs, means, vars = out
        a, b = 1.0 / vars, means / vars
        eta = torch.log(probs) - normal.A(a, b)
        return probs, means, vars, a, b, eta

    def _component(self, x, k):
        "Component k of a ``_components`` array: 0-d, or ``(B, 1)`` with lanes."
        return x[k].reshape(-1, 1) if self._lanes() else x[k]

    def _shape(self):
        return self.size if isinstance(self.size, tuple) else (self.size,)

    def out_shape(self):
        return self._shape()

    @property
    def a(self):
        return 1.0 / self.vars

    @property
    def b(self):
        return self.means / self.vars

    @property
    def eta(self):
        return torch.log(self.probs) - normal.A(self.a, self.b)

    def sample(self, generator):
        shape = self._shape()
        n = 1
        for s in shape:
            n *= s
        cluster = torch.multinomial(self.probs, n, replacement=True,
                                    generator=generator).reshape(shape)
        x = torch.randn(shape, generator=generator, device=self.probs.device,
                        dtype=self.probs.dtype)
        return self.means[cluster] + torch.sqrt(self.vars)[cluster] * x

    def second_moment(self):
        if self._lanes():
            return torch.sum(self.probs * (self.means**2 + self.vars), -1,
                             keepdim=True)
        return torch.sum(self.probs * (self.means**2 + self.vars))

    def forward_second_moment_FG(self, tx_hat):
        _, _, _, a, b, eta = self._components(torch.as_tensor(tx_hat).ndim)
        return mixture.tau(tx_hat + a, b, eta)

    # the elementwise SE integrands: the components in front of the nodes
    def _Kshape(self, ax, bx):
        _, _, _, a, b, eta = self._components(bx.ndim)
        return ax + a, bx + b, eta

    def scalar_forward_mean(self, ax, bx):
        return mixture.r(*self._Kshape(ax, bx))

    def scalar_forward_variance(self, ax, bx):
        return mixture.v(*self._Kshape(ax, bx))

    def scalar_log_partition(self, ax, bx):
        _, _, _, a0, b0, eta0 = self._components(bx.ndim)
        return mixture.A(*self._Kshape(ax, bx)) - mixture.A(a0, b0, eta0)

    def compute_forward_posterior(self, ax, bx):
        a, b, eta = self._Kshape(ax, bx)
        rx = mixture.r(a, b, eta)
        vx = mixture.v(a, b, eta)
        if self.isotropic:
            vx = lane_mean(vx, ax)
        return rx, vx

    def compute_log_partition(self, ax, bx):
        return lane_mean(self.scalar_log_partition(ax, bx), ax)

    def b_measure(self, mx_hat, qx_hat, tx0_hat, f):
        _, _, _, a, b, eta = self._components(torch.as_tensor(tx0_hat).ndim)
        a0 = a + tx0_hat
        r0 = b / a0
        v0 = 1.0 / a0
        p0 = mixture.p(a0, b, eta)
        mu = 0.0
        for k in range(self.K):
            c = [self._component(x, k) for x in (p0, r0, v0)]
            mu = mu + c[0] * gaussian_measure(
                mx_hat * c[1], torch.sqrt(qx_hat + mx_hat**2 * c[2]), f)
        return mu

    def bx_measure(self, mx_hat, qx_hat, tx0_hat, f):
        _, _, _, a, b, eta = self._components(torch.as_tensor(tx0_hat).ndim)
        a0 = a + tx0_hat
        r0 = b / a0
        v0 = 1.0 / a0
        p0 = mixture.p(a0, b, eta)
        ax_star = mx_hat**2 / qx_hat
        mu = 0.0
        for k in range(self.K):
            p_k, r_k, v_k, a_k, b_k = (self._component(x, k)
                                       for x in (p0, r0, v0, a0, b))

            def r_times_f(bx, a_k=a_k, b_k=b_k):
                bx_star = (mx_hat / qx_hat) * bx
                return (b_k + bx_star) / (a_k + ax_star) * f(bx)

            mu = mu + p_k * gaussian_measure(
                mx_hat * r_k, torch.sqrt(qx_hat + mx_hat**2 * v_k),
                r_times_f)
        return mu

    def beliefs_measure(self, ax, f):
        probs, means, vars, _, _, _ = self._components(ax.ndim)
        mu = 0.0
        for k in range(self.K):
            p_k, m_k, v_k = (self._component(x, k)
                             for x in (probs, means, vars))
            mu = mu + p_k * gaussian_measure(
                ax * m_k, torch.sqrt(ax + ax**2 * v_k), f)
        return mu

    def measure(self, f):
        probs, means, vars, _, _, _ = self._components(0)
        mu = 0.0
        for k in range(self.K):
            p_k, m_k, v_k = (self._component(x, k)
                             for x in (probs, means, vars))
            mu = mu + p_k * gaussian_measure(m_k, torch.sqrt(v_k), f)
        return mu
