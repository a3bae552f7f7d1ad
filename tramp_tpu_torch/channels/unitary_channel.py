"""Complex unitary channel x = U z. Counterpart of
tramp_tpu/channels/unitary_channel.py.

U is a complex buffer; messages keep the JAX package's packed re/im layout,
``(2, N)``, ``(B, 2, N)`` with lanes (utils/misc.py), and go through one
complex product per message (``pair_matmul``)."""
import math

import numpy as np
import torch

from .base_channel import Channel
from ..config import as_complex
from ..likelihoods.modulus_likelihood import _packed_axis
from ..lanes import lane_count, per_lane
from ..utils.misc import pair_matmul


def check_unitary(U):
    """Raise unless U is square and unitary to 1e-6, checked on the host in
    float64 (complex128) as the JAX package checks it with numpy: the
    check's tolerance is below float32's roundoff over N terms."""
    if isinstance(U, torch.Tensor):
        U = U.detach().cpu().numpy()
    U = np.asarray(U).astype(np.complex128)
    if U.ndim != 2 or U.shape[0] != U.shape[1]:
        raise ValueError(f"U.shape = {U.shape}")
    if not np.allclose(U @ U.conj().T, np.identity(U.shape[0]), atol=1e-6):
        raise ValueError("U not unitary")


class UnitaryChannel(Channel):
    """x = U z for a unitary (N, N) U, a complex buffer on ``device`` whose
    parts have ``dtype`` (None: those of a tensor ``U``, else the defaults
    of tramp_tpu_torch.config)."""

    _data_fields = ("U",)
    _meta_fields = ("name", "N")
    #: operators that ``parallel.shard_batched_model`` splits over the model
    #: axis (on their last axis; every product with them is made whole)
    _model_split_fields = ("U",)
    #: data fields the JAX package stores as packed (2, ...) re/im pairs
    _packed_fields = ("U",)

    def __init__(self, U, name="U", device=None, dtype=None):
        super().__init__()
        check_unitary(U)
        self.name = name
        self.register_buffer("U", as_complex(U, device, dtype))
        self.N = self.U.shape[-1]

    def math(self):
        return rf"${self.name}$"

    def sample(self, generator, Z):
        return pair_matmul(self.U, Z)

    def second_moment(self, tau_z):
        return tau_z

    def compute_forward_message(self, az, bz, ax, bx):
        return az, pair_matmul(self.U, bz, axis=_packed_axis(az, bz))

    def compute_backward_message(self, az, bz, ax, bx):
        return ax, pair_matmul(self.U, bx, adjoint=True,
                               axis=_packed_axis(ax, bx))

    def compute_forward_state_evolution(self, az, ax, tau_z):
        return az

    def compute_backward_state_evolution(self, az, ax, tau_z):
        return ax

    def compute_log_partition(self, az, bz, ax, bx):
        b = bz + pair_matmul(self.U, bx, adjoint=True,
                             axis=_packed_axis(ax, bx))
        a = az + ax
        lanes = lane_count(a, b) is not None
        quad = per_lane(0.5 * b**2 / a, lanes).sum(-1)
        return quad + (self.N * torch.log(2 * math.pi / a)).reshape(
            quad.shape)

    def compute_mutual_information(self, az, ax, tau_z):
        return 0.5 * torch.log((ax + az) * tau_z)

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + ax * tau_x) - I
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))
