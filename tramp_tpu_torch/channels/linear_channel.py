"""Dense linear channel x = W z, diagonalized once in the SVD basis.
Counterpart of tramp_tpu/channels/linear_channel.py.

EP messages are thin matvecs in the SVD basis against U (Nx, k) and
V (Nz, k), k = min(Nx, Nz); the matvecs are exact in the working dtype
(``torch.matmul``), or, with ``config.MATVEC_BF16``, take both operands
rounded to bfloat16 and accumulate in float32 (``_mm``). Modes beyond k
have resolvent 1/az, restored by the projector identity
V_perp V_perp^T = I - V V^T (``_backward_mean``).

A variable may carry a trailing K axis, ``(n, K)``, which the channel
multiplies as ``W @ Z`` (the JAX package's ``s[:, None]``).

Lanes (tramp_tpu_torch/lanes.py): messages of shape ``(B, n)`` or ``(B, n,
K)`` with precisions ``(B, 1)`` or ``(B, 1, 1)``; the precision tells lanes
from a trailing K axis (``lane_count``). With one shared operator
(two-dimensional factors) the B matvecs are one GEMM, ``x @ A``; with an
operator per lane (factors stacked to ``(B, Nx, k)``) they are one
``torch.bmm``. The spectral sums are taken per lane."""
import math

import torch

from .base_channel import Channel
from .. import config, trace
from ..config import as_tensor
from ..lanes import last_axis, lane_count, per_lane
from ..utils.misc import split_product


def _bf16(A):
    """The operator ``A`` rounded to bfloat16, made once and kept on the
    tensor for as long as it is unchanged (its version counter), so that a
    loop casts the loop-invariant U, V or W once, not at every product."""
    if A.is_meta:
        return A.to(torch.bfloat16)
    kept = getattr(A, "_bf16_copy", None)
    if kept is None or kept[0] != A._version:
        kept = A._bf16_copy = (A._version, A.to(torch.bfloat16))
    return kept[1]


def _mm_f32(a, b):
    """``a @ b`` of two bfloat16 matrices with float32 accumulation and a
    float32 result: ``torch.mm(..., out_dtype=torch.float32)`` on the card;
    elsewhere its plain form, the operands widened to float32 (each product
    of two bfloat16 numbers is exact in float32)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _bmm_f32(a, b):
    "``_mm_f32`` for batches of matrices (``torch.bmm``)."
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _product_bf16(A, x, lanes, transpose):
    """``A @ x`` (``A.T @ x``) in every layout ``LinearChannel._mm`` takes,
    ``A`` already bfloat16: float32 products of bfloat16 operands, as the
    JAX package's ``dot_general(..., preferred_element_type=float32)``."""
    x = x.to(torch.bfloat16)
    if A.ndim == 3:
        M = A.transpose(1, 2) if transpose else A
        if x.ndim == 3:
            return _bmm_f32(M, x)
        return _bmm_f32(M, x.unsqueeze(2)).squeeze(2)
    M = A.T if transpose else A
    if not lanes:
        if x.ndim == 1:
            return _mm_f32(M, x.unsqueeze(1)).squeeze(1)
        return _mm_f32(M, x)
    if x.ndim == 2:
        return _mm_f32(x, M.T)
    # (B, n, K): one product of M with the lanes' K columns side by side
    B, n, K = x.shape
    out = _mm_f32(M, x.transpose(0, 1).reshape(n, B * K))
    return out.reshape(-1, B, K).transpose(0, 1)


def _per_lane(x, a):
    """A spectrum ``(k,)``, or one per lane ``(B, k)`` lifted to ``(B, 1,
    ..., k)`` so that it broadcasts against a precision ``a`` ``(B, 1, ...)``
    of a variable with a trailing K axis."""
    if x.ndim == 2 and isinstance(a, torch.Tensor) and a.ndim > 2:
        return x.reshape((x.shape[0],) + (1,) * (a.ndim - 2) + x.shape[1:])
    return x


class LinearChannel(Channel):
    """x = W z with W of shape (Nx, Nz).
    Reference linear_channel.py:18-143 (SVD precompute l:39-44, resolvent
    backward mean l:69-83, n_eff spectral sums l:58-67).

    ``svd=(U, s, Vt)`` takes a precomputed decomposition (as the converter
    does, so that the column signs are the JAX package's); otherwise it is
    computed with ``torch.linalg.svd`` on W's device."""

    _data_fields = ("W", "U", "s", "V", "spectrum", "singular")
    _meta_fields = ("Nx", "Nz", "k", "rank", "alpha", "name")
    #: operators that ``parallel.shard_batched_model`` splits over the model
    #: axis (on their last axis; every product with them is made whole)
    _model_split_fields = ("W", "U", "V")

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
            with trace.span("svd"):
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

    def math(self):
        return rf"${self.name}$"

    def out_shape(self, shape):
        return (self.Nx,) + tuple(shape[1:])

    def sample(self, generator, Z):
        return self._mm(self.W, Z, lanes=False, bf16=False)

    def second_moment(self, tau_z):
        return tau_z * last_axis(self.spectrum, torch.sum) / self.Nx

    def compute_n_eff(self, az, ax):
        "Effective number of parameters / Nz. Reference l:58-67."
        ratio = az / torch.clamp(ax, min=1e-30)
        singular = _per_lane(self.singular, az)
        n_eff = last_axis(singular / (ratio + singular), torch.sum) / self.Nz
        return torch.where(ax == 0, 0.0, n_eff)

    @staticmethod
    def _mm(A, x, *, lanes, transpose=False, bf16=None):
        """``A @ x`` (or ``A.T @ x``) for the operator and its SVD-basis
        factors, for every lane of ``x``: ``x`` is ``(n,)`` or ``(n, K)``,
        with ``lanes`` ``(B, n)`` or ``(B, n, K)``; ``A`` one matrix or one
        per lane ``(B, rows, columns)``. The caller tells lanes from the
        precision (``lane_count``) or from its loop's lane count. Every
        product with a dense real operator goes through here, so an ``A``
        split over the model axis (``utils.misc.model_shard``) gives the
        whole product on every rank.

        With ``config.MATVEC_BF16`` (``bf16=None`` reads it; the log-partition
        and ``sample`` pass False, as the JAX package's plain products there)
        both operands are rounded to bfloat16 and the product accumulates in
        float32: the result is float32 whatever the dtype of ``A`` and ``x``
        (tramp_tpu/channels/linear_channel.py:67-84). ``A``'s bfloat16 copy
        is made once per operator."""
        if config.matvec_bf16() if bf16 is None else bf16:
            def product(A, x):
                return _product_bf16(_bf16(A), x, lanes, transpose)
        else:
            def product(A, x):
                if not lanes:
                    return (A.T if transpose else A) @ x
                if A.ndim == 3:
                    if x.ndim == 3:
                        return torch.bmm(
                            A.transpose(1, 2) if transpose else A, x)
                    if transpose:
                        return torch.bmm(x.unsqueeze(1), A).squeeze(1)
                    return torch.bmm(A, x.unsqueeze(2)).squeeze(2)
                if x.ndim == 2:
                    return x @ (A if transpose else A.T)
                return torch.matmul(A.T if transpose else A, x)

        return split_product(A, x, 1 if lanes else 0, transpose, product)

    def _s(self, a, b):
        """The singular values as they broadcast against the k-length image
        of ``b``: ``s[..., None]`` when the variable has a trailing K axis
        (the JAX package's ``s[:, None]``)."""
        lanes = lane_count(a, b) is not None
        return self.s[..., None] if b.ndim > (2 if lanes else 1) else self.s

    def spectral_image(self, bx, ax=None):
        """The image u = U^T bx (k-length) that the EP engine carries; the
        precision ``ax`` tells lanes from a trailing K axis (None: ``bx``
        has no lanes)."""
        return self._mm(self.U, bx, transpose=True,
                        lanes=lane_count(ax, bx) is not None)

    def _mean_svd(self, az, bz, ax, u):
        """k-length spectral mean m = res_k (V^T bz + s u) with
        res_k = 1/(az + ax s^2), t = V^T bz, and the broadcast s. Ref
        linear_channel.py l:69-83 and l:115-121, on the thin factors only."""
        lanes = lane_count(az, bz) is not None
        t = self._mm(self.V, bz, transpose=True, lanes=lanes)
        s = self._s(az, bz)
        res = 1.0 / (az + ax * s**2)
        return res * (t + s * u), t, s, lanes

    def _forward_mean(self, az, bz, ax, u):
        "rx = W rz = U (s * m): only the k signal modes contribute."
        m, _, s, lanes = self._mean_svd(az, bz, ax, u)
        return self._mm(self.U, s * m, lanes=lanes)

    def _backward_mean(self, az, bz, ax, u):
        "rz = V m, with the complement modes (s = 0) at resolvent 1/az."
        m, t, _, lanes = self._mean_svd(az, bz, ax, u)
        if self.k == self.Nz:
            return self._mm(self.V, m, lanes=lanes)
        # V_perp V_perp^T bz / az = (bz - V_k V_k^T bz) / az
        return bz / az + self._mm(self.V, m - t / az, lanes=lanes)

    def compute_forward_mean(self, az, bz, ax, bx):
        return self._forward_mean(az, bz, ax, self.spectral_image(bx, ax))

    def compute_backward_mean(self, az, bz, ax, bx):
        return self._backward_mean(az, bz, ax, self.spectral_image(bx, ax))

    # The posteriors take u = U^T bx as an argument: the EP engine passes
    # the image it carried from the previous backward pass (or, for a
    # pinned bx, the image of the run), so all paths run the same code.
    def spectral_forward_posterior(self, az, bz, ax, u):
        "(rx, vx) from the image u = U^T bx."
        return (self._forward_mean(az, bz, ax, u),
                self.compute_forward_variance(az, ax))

    def spectral_backward_posterior(self, az, bz, ax, bx, u=None):
        """(rz, vz, u): the fresh u = U^T bx (or the given image) becomes
        the carried image."""
        u = self.spectral_image(bx, ax) if u is None else u
        return (self._backward_mean(az, bz, ax, u),
                self.compute_backward_variance(az, ax), u)

    def compute_backward_variance(self, az, ax):
        az = torch.clamp(az, min=1e-11)
        n_eff = self.compute_n_eff(az, ax)
        return (1.0 - n_eff) / az

    def compute_forward_variance(self, az, ax):
        s_mean = last_axis(_per_lane(self.singular, az), torch.mean)
        v0 = s_mean * self.rank / (self.Nx * az)  # ax == 0 limit (ref l:97-99)
        n_eff = self.compute_n_eff(az, ax)
        v = n_eff / (self.alpha * torch.clamp(ax, min=1e-30))
        return torch.where(ax == 0, v0, v)

    def compute_backward_posterior(self, az, bz, ax, bx):
        return self.spectral_backward_posterior(az, bz, ax, bx)[:2]

    def compute_forward_posterior(self, az, bz, ax, bx):
        return self.spectral_forward_posterior(az, bz, ax,
                                               self.spectral_image(bx, ax))

    # -- SE and the Bethe objective (reference l:168-187) ------------------
    def compute_backward_error(self, az, ax, tau_z):
        return self.compute_backward_variance(az, ax)

    def compute_forward_error(self, az, ax, tau_z):
        return self.compute_forward_variance(az, ax)

    def compute_log_partition(self, az, bz, ax, bx):
        rz = self.compute_backward_posterior(az, bz, ax, bx)[0]
        lanes = lane_count(az, bz) is not None
        b = bz + self._mm(self.W, bx, transpose=True, lanes=lanes,
                          bf16=False)
        # the log term sums over the Nz modes only, also with a trailing
        # K axis, as the JAX package's does
        if lanes:
            az, ax = az.reshape(-1, 1), ax.reshape(-1, 1)
        a = az + ax * self.spectrum
        return (0.5 * per_lane(b * rz, lanes).sum(-1)
                + 0.5 * per_lane(torch.log(2 * math.pi / a), lanes).sum(-1))

    def compute_mutual_information(self, az, ax, tau_z):
        return last_axis(
            0.5 * torch.log((az + ax * self.spectrum) * tau_z), torch.mean)

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + self.alpha * ax * tau_x) - I
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))
