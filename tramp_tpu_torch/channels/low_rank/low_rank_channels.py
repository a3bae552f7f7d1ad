"""Low-rank channels delegating to the embedded VAMP solver. Counterpart of
tramp_tpu/channels/low_rank/low_rank_channels.py (reference
low_rank_gram_channel.py:7-65 and low_rank_factorization.py:7-78).

Within a sweep the forward and the backward posterior each run a full
embedded solve, as in the JAX package. ``stats``, a dict on the factor,
counts the solves and their loop iterations."""
import math

import torch

from ..base_channel import Channel, MatrixFactorization
from .vamp_solver import (vamp_matrix_factorization,
                          forward_posterior_from_marginals,
                          se_matrix_factorization)


def _solve(factor, model, au, av, bu, bv, ax, bx):
    "The embedded solve with its marginals, counted in ``factor.stats``."
    return vamp_matrix_factorization(
        au=au, av=av, bu=bu, bv=bv, ax=ax, bx=bx, model=model,
        return_marginals=True,
        stats=factor.__dict__.setdefault("stats", {}))


class LowRankGramChannel(Channel):
    """x = z z^T / sqrt(N) with z of shape (N, K).
    Reference low_rank_gram_channel.py:7-65."""

    _data_fields = ()
    _meta_fields = ("N", "K")

    def __init__(self, N, K):
        super().__init__()
        self.N = N
        self.K = K

    def math(self):
        return r"$zz^T$"

    def out_shape(self, shape):
        return (self.N, self.N)

    def sample(self, generator, Z):
        return Z @ Z.T / math.sqrt(self.N)

    def second_moment(self, tau_z):
        # ignore O(1/N^2) terms (reference l:31-34)
        return self.K * tau_z * tau_z / self.N

    def compute_forward_posterior(self, az, bz, ax, bx):
        # the JAX package's moment-matched posterior where the reference
        # stubs one (low_rank_gram_channel.py:36-41)
        *_, (Z_hat, C_Z, _, _) = _solve(self, "XX", az, az, bz, bz, ax, bx)
        rx, vx = forward_posterior_from_marginals(
            Z_hat, C_Z, Z_hat, C_Z, self.N)
        # the diagonal of the Gram case is a same-row product:
        # E[x_ii] = (|z_i|^2 + tr(C_i)) / sqrt(N) (commit e5b3ed1)
        tr = torch.diagonal(C_Z, dim1=-2, dim2=-1).sum(-1)
        rx = rx + torch.diag_embed(tr) / math.sqrt(1.0 * self.N)
        return rx, vx

    def compute_backward_posterior(self, az, bz, ax, bx):
        _, _, rz_v, vz_v, _ = _solve(self, "XX", az, az, bz, bz, ax, bx)
        return rz_v, vz_v

    def compute_backward_error(self, az, ax, tau_z):
        # the isotropic zero-mean contract: the scalar recursion (the
        # reference's K x K formulas diverge at high SNR)
        return se_matrix_factorization(
            au=az, av=az, ax=ax, model="XX", K=self.K, N=self.N, M=self.N)


class LowRankFactorization(MatrixFactorization):
    """x = u v^T / sqrt(N) with u (M, K), v (N, K).
    Reference low_rank_factorization.py:7-78."""

    _data_fields = ()
    _meta_fields = ("M", "N", "K")

    def __init__(self, M, N, K):
        super().__init__()
        self.M = M
        self.N = N
        self.K = K

    def math(self):
        return r"$uv^T$"

    def out_shape(self, shape_u, shape_v):
        return (self.M, self.N)

    def sample(self, generator, U, V):
        return U @ V.T / math.sqrt(self.N)

    def second_moment(self, tau_u, tau_v):
        return self.K * tau_u * tau_v / self.N

    def compute_forward_posterior(self, az, bz, ax, bx):
        # the JAX package's moment-matched posterior where the reference
        # stubs one (low_rank_factorization.py:43-46)
        (au, av), (bu, bv) = az, bz
        *_, (U_hat, C_U, V_hat, C_V) = _solve(self, "UV", au, av, bu, bv,
                                                 ax, bx)
        return forward_posterior_from_marginals(
            U_hat, C_U, V_hat, C_V, self.N)

    def compute_backward_posterior(self, az, bz, ax, bx):
        (au, av), (bu, bv) = az, bz
        rz_u, vz_u, rz_v, vz_v, _ = _solve(self, "UV", au, av, bu, bv, ax, bx)
        return [rz_u, rz_v], [vz_u, vz_v]

    def compute_backward_error(self, az, ax, tau_z):
        # scalar recursion, as LowRankGramChannel
        au, av = az
        vz_u, vz_v = se_matrix_factorization(
            au=au, av=av, ax=ax, model="UV", K=self.K, N=self.N, M=self.M)
        return [vz_u, vz_v]
