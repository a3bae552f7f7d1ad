"""Dense linear channel x = W z, diagonalized once in the SVD basis.
Counterpart of tramp_tpu/channels/linear_channel.py (EP part).

EP messages are thin matvecs in the SVD basis against U (Nx, k) and
V (Nz, k), k = min(Nx, Nz); the matvecs are exact in the working dtype
(``torch.matmul``). Modes beyond k have resolvent 1/az, restored by the
projector identity V_perp V_perp^T = I - V V^T
(spectral_backward_posterior)."""
import torch

from .base_channel import Channel
from ..config import as_tensor


class LinearChannel(Channel):
    """x = W z with W of shape (Nx, Nz).
    Reference linear_channel.py:18-143 (SVD precompute l:39-44, resolvent
    backward mean l:69-83, n_eff spectral sums l:58-67).

    ``svd=(U, s, Vt)`` takes a precomputed decomposition (as the converter
    does, so that the column signs are the JAX package's); otherwise it is
    computed with ``torch.linalg.svd`` on W's device."""

    _data_fields = ("W", "U", "s", "V", "spectrum", "singular")
    _meta_fields = ("Nx", "Nz", "k", "rank", "alpha", "name")

    def __init__(self, W, name="W", rank=None, svd=None, device=None,
                 dtype=None):
        super().__init__()
        W = as_tensor(W, device, dtype)
        self.Nx, self.Nz = W.shape
        self.name = name
        k = min(self.Nx, self.Nz)
        self.k = k
        if svd is not None:
            U, s, Vt = (as_tensor(t, W.device, W.dtype) for t in svd)
        else:
            U, s, Vt = torch.linalg.svd(W, full_matrices=False)
        self.register_buffer("W", W)
        self.register_buffer("U", U[:, :k].contiguous())    # (Nx, k)
        self.register_buffer("V", Vt[:k].T.contiguous())    # (Nz, k)
        self.register_buffer("s", s[:k].contiguous())       # (k,)
        # spectrum of W^T W, length Nz (padded with zeros)
        spectrum = torch.zeros(self.Nz, dtype=W.dtype, device=W.device)
        spectrum[:k] = s**2
        self.register_buffer("spectrum", spectrum)
        self.rank = rank if rank is not None else int(
            torch.sum(s > s[0] * max(self.Nx, self.Nz) * 1e-12))
        self.register_buffer("singular", spectrum[:self.rank].clone())
        self.alpha = self.Nx / self.Nz

    def out_shape(self, shape):
        return (self.Nx,) + tuple(shape[1:])

    def sample(self, generator, Z):
        return self.W @ Z

    def compute_n_eff(self, az, ax):
        "Effective number of parameters / Nz. Reference l:58-67."
        ratio = az / torch.clamp(ax, min=1e-30)
        n_eff = torch.sum(self.singular / (ratio + self.singular)) / self.Nz
        return torch.where(ax == 0, 0.0, n_eff)

    @staticmethod
    def _mm(A, x, transpose=False):
        "``A @ x`` (or ``A.T @ x``) for the SVD-basis factors."
        return (A.T if transpose else A) @ x

    def spectral_image(self, bx):
        "The image u = U^T bx (k-length) that the EP engine carries."
        return self._mm(self.U, bx, transpose=True)

    def _mean_svd(self, az, bz, ax, u):
        """k-length spectral mean m = res_k (V^T bz + s u) with
        res_k = 1/(az + ax s^2), and t = V^T bz. Ref linear_channel.py
        l:69-83, on the thin factors only."""
        t = self._mm(self.V, bz, transpose=True)
        res = 1.0 / (az + ax * self.s**2)
        return res * (t + self.s * u), t

    # The posteriors take u = U^T bx as an argument: the EP engine passes
    # the image it carried from the previous backward pass, so the cached
    # and uncached paths run the same code.
    def spectral_forward_posterior(self, az, bz, ax, u):
        "(rx, vx): rx = W rz = U (s * m), only the k signal modes contribute."
        m, _ = self._mean_svd(az, bz, ax, u)
        rx = self._mm(self.U, self.s * m)
        return rx, self.compute_forward_variance(az, ax)

    def spectral_backward_posterior(self, az, bz, ax, bx):
        "(rz, vz, u): the fresh u = U^T bx becomes the carried image."
        u = self.spectral_image(bx)
        m, t = self._mean_svd(az, bz, ax, u)
        if self.k == self.Nz:
            rz = self._mm(self.V, m)
        else:
            # complement modes (s=0) have resolvent 1/az:
            #   V_perp V_perp^T bz / az = (bz - V_k V_k^T bz) / az
            rz = bz / az + self._mm(self.V, m - t / az)
        return rz, self.compute_backward_variance(az, ax), u

    def compute_backward_variance(self, az, ax):
        az = torch.clamp(az, min=1e-11)
        n_eff = self.compute_n_eff(az, ax)
        return (1.0 - n_eff) / az

    def compute_forward_variance(self, az, ax):
        s_mean = torch.mean(self.singular)
        v0 = s_mean * self.rank / (self.Nx * az)  # ax == 0 limit (ref l:97-99)
        n_eff = self.compute_n_eff(az, ax)
        v = n_eff / (self.alpha * torch.clamp(ax, min=1e-30))
        return torch.where(ax == 0, v0, v)

    def compute_backward_posterior(self, az, bz, ax, bx):
        return self.spectral_backward_posterior(az, bz, ax, bx)[:2]

    def compute_forward_posterior(self, az, bz, ax, bx):
        return self.spectral_forward_posterior(az, bz, ax,
                                               self.spectral_image(bx))
