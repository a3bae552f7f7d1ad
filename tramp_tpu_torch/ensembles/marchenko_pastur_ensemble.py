"""Marchenko-Pastur analytic spectral ensemble. Counterpart of
tramp_tpu/ensembles/marchenko_pastur_ensemble.py."""
import math

import torch

from ..config import default_device, DEFAULT_DTYPE
from ..utils.integration import composite_gauss_legendre


class MarchenkoPasturEnsemble:

    def __init__(self, alpha):
        self.alpha = alpha
        self.z_max = (1 + math.sqrt(alpha)) ** 2
        self.z_min = (1 - math.sqrt(alpha)) ** 2
        self.mean_spectrum = float(self.measure(lambda z: z))

    def __repr__(self):
        return f"MarchenkoPasturEnsemble(alpha={self.alpha})"

    def generate(self, generator=None, N=1000, device=None, dtype=None):
        M = int(self.alpha * N)
        device = device or (generator.device if generator is not None
                            else default_device())
        return torch.randn((M, N), generator=generator, device=device,
                           dtype=dtype or DEFAULT_DTYPE) / math.sqrt(N)

    def bulk_density(self, z):
        return (torch.sqrt((z - self.z_min) * (self.z_max - z))
                / (2 * math.pi * z))

    def measure(self, f):
        """Atomic part + bulk integral (composite Gauss-Legendre over the
        bulk), in float64 on the CPU: a constant of the ensemble."""
        zero = torch.zeros((), dtype=torch.float64)
        atomic = max(0.0, 1.0 - self.alpha) * f(zero)
        x, w = (torch.as_tensor(a) for a in composite_gauss_legendre(
            float(self.z_min), float(self.z_max), 20, 20))
        bulk = torch.sum(w * f(x) * self.bulk_density(x))
        return atomic + bulk

    def compute_F(self, gamma):
        return (torch.sqrt(gamma * self.z_max + 1)
                - torch.sqrt(gamma * self.z_min + 1)) ** 2

    def eta_transform(self, gamma):
        F = self.compute_F(gamma)
        return 1 - F / (4 * torch.clamp(gamma, min=1e-30))

    def shannon_transform(self, gamma):
        F = self.compute_F(gamma)
        return (torch.log(1 + self.alpha * gamma - F / 4)
                + self.alpha * torch.log(1 + gamma - F / 4)
                - F / (4 * gamma))
