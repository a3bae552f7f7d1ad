"""Complex linear channel x = W z, diagonalized once by a thin complex SVD.
Counterpart of tramp_tpu/channels/complex_linear_channel.py.

W and the SVD factors U (Nx, k), V (Nz, k) are complex buffers, k =
min(Nx, Nz); s and the spectrum are real. Messages keep the JAX package's
packed re/im layout (``(2, n)``, ``(B, 2, n)`` with lanes, whose precision
is ``(B, 1, 1)``), and each product is one complex matrix product
(utils/misc.py ``pair_matmul``): cuBLAS on the card, as the JAX package
computes these products outside any Pallas kernel. Modes beyond k have
resolvent 1/az, restored by V_perp V_perp^H = I - V V^H."""
import math

import torch

from .base_channel import Channel
from ..config import as_complex
from ..lanes import last_axis, lane_count, per_lane
from ..likelihoods.modulus_likelihood import _packed_axis
from ..utils.misc import pair_matmul


def _per_lane(x):
    """A spectrum ``(k,)``, or one per lane ``(B, k)`` lifted to ``(B, 1,
    k)`` so that it broadcasts against packed ``(B, 2, k)`` and precisions
    ``(B, 1, 1)``."""
    return x.unsqueeze(-2) if x.ndim == 2 else x


class ComplexLinearChannel(Channel):
    """x = W z with a complex W of shape (Nx, Nz), a numpy array or a
    complex tensor, on ``device`` with parts of ``dtype`` (None: those of a
    tensor ``W``, else the defaults of tramp_tpu_torch.config).

    ``svd=(U, s, Vh)`` takes a precomputed decomposition (the converter
    carries the JAX package's, whose column phases differ from torch's);
    otherwise it is computed with ``torch.linalg.svd`` on W's device."""

    _data_fields = ("W", "U", "s", "V", "spectrum", "singular")
    _meta_fields = ("Nx", "Nz", "k", "rank", "alpha", "name")
    #: operators that ``parallel.shard_batched_model`` splits over the model
    #: axis (on their last axis; every product with them is made whole)
    _model_split_fields = ("W", "U", "V")
    #: data fields the JAX package stores as packed (2, ...) re/im pairs
    _packed_fields = ("W", "U", "V")

    def __init__(self, W, name="W", rank=None, svd=None, device=None,
                 dtype=None):
        super().__init__()
        W = as_complex(W, device, dtype)
        self.Nx, self.Nz = W.shape
        self.name = name
        k = self.k = min(self.Nx, self.Nz)
        real = W.real.dtype
        if svd is not None:
            U, s, Vh = svd
            U, Vh = (as_complex(t, W.device, real) for t in (U, Vh))
            s = torch.as_tensor(s).real.to(W.device, real)
        else:
            U, s, Vh = torch.linalg.svd(W, full_matrices=False)
        s = s[:k]
        self.register_buffer("W", W)
        self.register_buffer("U", U[:, :k].contiguous())
        self.register_buffer("V", Vh[:k].conj().T.contiguous())
        self.register_buffer("s", s.contiguous())
        spectrum = torch.zeros(self.Nz, dtype=real, device=W.device)
        spectrum[:k] = s**2
        self.register_buffer("spectrum", spectrum)
        self.rank = rank if rank is not None else int(
            torch.sum(s > s[0] * max(self.Nx, self.Nz) * 1e-12))
        self.register_buffer("singular", spectrum[:self.rank].clone())
        self.alpha = self.Nx / self.Nz

    def math(self):
        return rf"${self.name}$"

    def out_shape(self, shape):
        return (2, self.Nx) + tuple(shape[2:])

    def sample(self, generator, Z):
        return pair_matmul(self.W, Z)

    def second_moment(self, tau_z):
        return tau_z * last_axis(self.spectrum, torch.sum) / self.Nx

    def compute_n_eff(self, az, ax):
        ratio = az / torch.clamp(ax, min=1e-30)
        singular = _per_lane(self.singular)
        n_eff = last_axis(singular / (ratio + singular), torch.sum) / self.Nz
        return torch.where(ax == 0, 0.0, n_eff)

    def _mean_svd(self, az, bz, ax, bx):
        """k-length packed spectral mean m = res_k (V^H bz + s U^H bx), and
        t = V^H bz for the complement term."""
        axis = _packed_axis(az, bz)
        u = pair_matmul(self.U, bx, adjoint=True, axis=axis)
        t = pair_matmul(self.V, bz, adjoint=True, axis=axis)
        s = _per_lane(self.s)
        resolvent = 1.0 / (az + ax * s**2)
        return resolvent * (t + s * u), t, axis

    def compute_backward_mean(self, az, bz, ax, bx):
        m, t, axis = self._mean_svd(az, bz, ax, bx)
        if self.k == self.Nz:
            return pair_matmul(self.V, m, axis=axis)
        # complement modes (s=0): V_perp V_perp^H bz / az = (bz - V t)/az
        return bz / az + pair_matmul(self.V, m - t / az, axis=axis)

    def compute_forward_mean(self, az, bz, ax, bx):
        # rx = W rz = U (s * m): only the k signal modes contribute
        m, _, axis = self._mean_svd(az, bz, ax, bx)
        return pair_matmul(self.U, _per_lane(self.s) * m, axis=axis)

    def compute_backward_variance(self, az, ax):
        return (1.0 - self.compute_n_eff(az, ax)) / az

    def compute_forward_variance(self, az, ax):
        s_mean = last_axis(_per_lane(self.singular), torch.mean)
        v0 = s_mean * self.rank / (self.Nx * az)
        n_eff = self.compute_n_eff(az, ax)
        v = n_eff / (self.alpha * torch.clamp(ax, min=1e-30))
        return torch.where(ax == 0, v0, v)

    def compute_backward_posterior(self, az, bz, ax, bx):
        return (self.compute_backward_mean(az, bz, ax, bx),
                self.compute_backward_variance(az, ax))

    def compute_forward_posterior(self, az, bz, ax, bx):
        return (self.compute_forward_mean(az, bz, ax, bx),
                self.compute_forward_variance(az, ax))

    def compute_backward_error(self, az, ax, tau_z):
        return self.compute_backward_variance(az, ax)

    def compute_forward_error(self, az, ax, tau_z):
        return self.compute_forward_variance(az, ax)

    def compute_log_partition(self, az, bz, ax, bx):
        rz = self.compute_backward_mean(az, bz, ax, bx)
        axis = _packed_axis(az, bz)
        b = bz + pair_matmul(self.W, bx, adjoint=True, axis=axis)
        a = az + ax * _per_lane(self.spectrum)
        lanes = lane_count(az, bz) is not None
        return (0.5 * per_lane(b * rz, lanes).sum(-1)
                + per_lane(torch.log(2 * math.pi / a), lanes).sum(-1))

    def compute_mutual_information(self, az, ax, tau_z):
        return last_axis(
            0.5 * torch.log((az + ax * self.spectrum) * tau_z), torch.mean)

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + self.alpha * ax * tau_x) - I
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))
