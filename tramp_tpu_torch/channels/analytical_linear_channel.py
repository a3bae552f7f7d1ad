"""Ensemble-averaged linear channels for state evolution (no matrix, no N).
Counterpart of tramp_tpu/channels/analytical_linear_channel.py."""
import math

import torch

from .base_channel import Channel
from ..lanes import sqrt


class AnalyticalLinearChannel(Channel):
    "SE-only channel parameterized by a spectral ensemble. Ref l:8-64."

    _data_fields = ()
    _meta_fields = ("name", "alpha", "ensemble")

    def __init__(self, ensemble, name="W"):
        super().__init__()
        self.name = name
        self.alpha = ensemble.alpha
        self.ensemble = ensemble

    def math(self):
        return rf"${self.name}$"

    def sample(self, generator, Z):
        F = self.ensemble.generate(generator, Z.shape[0], device=Z.device,
                                   dtype=Z.dtype)
        return F @ Z

    def second_moment(self, tau_z):
        return tau_z * (self.ensemble.mean_spectrum / self.alpha)

    def compute_n_eff(self, az, ax):
        gamma = ax / torch.clamp(az, min=1e-30)
        n_eff = 1.0 - self.ensemble.eta_transform(gamma)
        return torch.where(ax == 0, 0.0, n_eff)

    def compute_backward_error(self, az, ax, tau_z):
        az = torch.clamp(az, min=1e-11)
        n_eff = self.compute_n_eff(az, ax)
        return (1.0 - n_eff) / az

    def compute_forward_error(self, az, ax, tau_z):
        v0 = self.ensemble.mean_spectrum / (
            self.alpha * torch.clamp(az, min=1e-30))
        n_eff = self.compute_n_eff(az, ax)
        v = n_eff / (self.alpha * torch.clamp(ax, min=1e-30))
        return torch.where(ax == 0, v0, v)

    def compute_mutual_information(self, az, ax, tau_z):
        gamma = ax / az
        S = self.ensemble.shannon_transform(gamma)
        return 0.5 * torch.log(az * tau_z) + 0.5 * S

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + self.alpha * ax * tau_x) - I
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))


class MarchenkoPasturChannel(AnalyticalLinearChannel):
    """Closed-form Marchenko-Pastur SE channel. Reference l:68-92.

    ``alpha`` is a numeric hyperparameter (all MP transforms are closed-form
    in alpha): a Python number, or one value per lane as a tensor ``(B, 1)``,
    so models over an (alpha, rho) grid stack into one batched SE sweep
    (``lanes.stack_models``)."""

    _data_fields = ("alpha",)
    _meta_fields = ("name",)

    def __init__(self, alpha, name="W"):
        Channel.__init__(self)
        self.name = name
        self.alpha = alpha

    @property
    def ensemble(self):
        from ..ensembles import MarchenkoPasturEnsemble
        return MarchenkoPasturEnsemble(alpha=float(self.alpha))

    def sample(self, generator, Z):
        """F @ Z with F an (alpha N, N) Gaussian matrix of variance 1 / N
        (reference l:83-87), drawn with ``generator`` on Z's device."""
        N = Z.shape[0]
        M = int(float(self.alpha) * N)
        F = torch.randn((M, N), generator=generator, device=Z.device,
                        dtype=Z.dtype) / math.sqrt(N)
        return F @ Z

    def second_moment(self, tau_z):
        # int z dMP(z) = alpha exactly (bulk mean; the atom at 0 contributes
        # nothing), so mean_spectrum / alpha = 1
        if isinstance(self.alpha, torch.Tensor):
            return tau_z * torch.ones_like(self.alpha)
        return tau_z

    def _F(self, gamma):
        "(sqrt(gamma z_max + 1) - sqrt(gamma z_min + 1))^2, MP edges."
        sqa = sqrt(self.alpha)
        z_max = (1 + sqa) ** 2
        z_min = (1 - sqa) ** 2
        return (torch.sqrt(gamma * z_max + 1)
                - torch.sqrt(gamma * z_min + 1)) ** 2

    def compute_n_eff(self, az, ax):
        gamma = ax / torch.clamp(az, min=1e-30)
        F = self._F(gamma)
        eta = 1 - F / (4 * torch.clamp(gamma, min=1e-30))
        return torch.where(ax == 0, 0.0, 1.0 - eta)

    def compute_forward_error(self, az, ax, tau_z):
        v0 = 1.0 / torch.clamp(az, min=1e-30)
        n_eff = self.compute_n_eff(az, ax)
        v = n_eff / (self.alpha * torch.clamp(ax, min=1e-30))
        return torch.where(ax == 0, v0, v)

    def compute_mutual_information(self, az, ax, tau_z):
        gamma = ax / az
        F = self._F(gamma)
        S = (torch.log(1 + self.alpha * gamma - F / 4)
             + self.alpha * torch.log(1 + gamma - F / 4)
             - F / (4 * gamma))
        return 0.5 * torch.log(az * tau_z) + 0.5 * S

    def compute_precision(self, vz, vx, tau_z):
        ax = 1.0 / vx - 1.0 / vz
        az = (1.0 - self.alpha * ax * vx) / vz
        return az, ax

    def compute_dual_mutual_information(self, vz, vx, tau_z):
        Iz = 0.5 * torch.log(tau_z / vz) - 0.5
        J = 0.5 * self.alpha * (torch.log(vz / vx) + vx / vz - 1.0)
        return J + Iz

    def compute_dual_free_energy(self, mz, mx, tau_z):
        tau_x = self.second_moment(tau_z)
        I_dual = self.compute_dual_mutual_information(
            tau_z - mz, tau_x - mx, tau_z)
        return I_dual - 0.5 * torch.log(2 * math.pi * tau_z / math.e)
