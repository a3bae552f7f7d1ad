"""Orthogonal rotation channel x = R z (its messages are rotations only).
Counterpart of tramp_tpu/channels/rotation_channel.py.

Lanes: messages ``(B, N)`` (or ``(B, N, K)``) with precisions ``(B, 1)``
(``(B, 1, 1)``), under one shared R or one per lane, ``(B, N, N)``."""
import math

import numpy as np
import torch

from .base_channel import Channel
from ..config import as_tensor
from ..lanes import lane_count, per_lane


def check_rotation(R):
    R = (R.detach().cpu().numpy() if isinstance(R, torch.Tensor)
         else np.asarray(R))
    if R.shape[0] != R.shape[1]:
        raise ValueError(f"R.shape = {R.shape}")
    if not np.allclose(R @ R.T, np.identity(R.shape[0]), atol=1e-6):
        raise ValueError("R not a rotation")


class RotationChannel(Channel):
    """Reference rotation_channel.py:19-62. ``R`` on ``device`` with
    ``dtype`` (None: those of a tensor ``R``, else the first card and the
    default dtype)."""

    _data_fields = ("R",)
    _meta_fields = ("name", "N")

    def __init__(self, R, name="R", device=None, dtype=None):
        super().__init__()
        check_rotation(R)
        self.name = name
        self.N = R.shape[0]
        self.register_buffer("R", as_tensor(R, device, dtype))

    def math(self):
        return rf"${self.name}$"

    def sample(self, generator, Z):
        return self.R @ Z

    def _rotate(self, a, b, transpose=False):
        "R b (R^T b) for every lane of b; the precision tells lanes."
        R = self.R.transpose(-1, -2) if transpose else self.R
        if lane_count(a, b) is None:
            return R @ b
        if b.ndim == 2:
            return torch.matmul(R, b.unsqueeze(-1)).squeeze(-1)
        return torch.matmul(R, b)

    def second_moment(self, tau_z):
        return tau_z

    def compute_forward_message(self, az, bz, ax, bx):
        return az, self._rotate(az, bz)

    def compute_backward_message(self, az, bz, ax, bx):
        return ax, self._rotate(ax, bx, transpose=True)

    def compute_forward_state_evolution(self, az, ax, tau_z):
        return az

    def compute_backward_state_evolution(self, az, ax, tau_z):
        return ax

    def compute_log_partition(self, az, bz, ax, bx):
        lanes = lane_count(az, bz) is not None
        b = bz + self._rotate(ax, bx, transpose=True)
        a = az + ax
        log_term = 0.5 * self.N * torch.log(2 * math.pi / a)
        return (0.5 * per_lane(b**2 / a, lanes).sum(-1)
                + (log_term.reshape(-1) if lanes else log_term))

    def compute_mutual_information(self, az, ax, tau_z):
        return 0.5 * torch.log((ax + az) * tau_z)

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + ax * tau_x) - I
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))
