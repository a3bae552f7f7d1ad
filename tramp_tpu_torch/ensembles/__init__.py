"""Random matrix ensembles. Counterpart of tramp_tpu/ensembles;
``generate`` draws with a ``torch.Generator`` on its device (None: the
first card). The complex ensembles return complex tensors whose parts have
``dtype``. The registry has every type of the JAX package's."""
import math

import torch

from ..config import default_device, DEFAULT_DTYPE
from .marchenko_pastur_ensemble import MarchenkoPasturEnsemble


def _device(generator, device):
    return device or (generator.device if generator is not None
                      else default_device())


class Ensemble:
    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({args})"


class GaussianEnsemble(Ensemble):
    "iid N(0, 1/N). Reference gaussian_ensemble.py:5-22."

    def __init__(self, M, N):
        self.M = M
        self.N = N

    def generate(self, generator=None, device=None, dtype=None):
        return torch.randn((self.M, self.N), generator=generator,
                           device=_device(generator, device),
                           dtype=dtype or DEFAULT_DTYPE) / math.sqrt(self.N)


class ComplexGaussianEnsemble(Ensemble):
    """Complex iid, real and imaginary parts N(0, 1/N). Reference
    complex_gaussian_ensemble.py."""

    def __init__(self, M, N):
        self.M = M
        self.N = N

    def generate(self, generator=None, device=None, dtype=None):
        kw = dict(generator=generator, device=_device(generator, device),
                  dtype=dtype or DEFAULT_DTYPE)
        re = torch.randn((self.M, self.N), **kw)
        im = torch.randn((self.M, self.N), **kw)
        return torch.complex(re, im) / math.sqrt(self.N)


class UnitaryEnsemble(Ensemble):
    "Haar U(N) matrix. Reference unitary_ensemble.py:5-19."

    def __init__(self, N):
        self.N = N

    def generate(self, generator=None, device=None, dtype=None):
        kw = dict(generator=generator, device=_device(generator, device),
                  dtype=dtype or DEFAULT_DTYPE)
        A = torch.complex(torch.randn((self.N, self.N), **kw),
                          torch.randn((self.N, self.N), **kw))
        Q, R = torch.linalg.qr(A)
        d = torch.diagonal(R)
        return Q * (d / torch.abs(d))


class RotationEnsemble(Ensemble):
    "Haar SO(N) matrix. Reference rotation_ensemble.py:5-19."

    def __init__(self, N):
        self.N = N

    def generate(self, generator=None, device=None, dtype=None):
        A = torch.randn((self.N, self.N), generator=generator,
                        device=_device(generator, device),
                        dtype=dtype or DEFAULT_DTYPE)
        Q, R = torch.linalg.qr(A)
        Q = Q * torch.sign(torch.diagonal(R))
        # determinant +1 (SO(N))
        Q[:, 0] = Q[:, 0] * torch.sign(torch.linalg.det(Q))
        return Q


class BinaryEnsemble(Ensemble):
    """iid +-1/sqrt(N) with P(+) = p_pos. Reference binary_ensemble.py:5-28
    (the JAX package implements the documented p_pos, which the reference
    ignores)."""

    def __init__(self, M, N, p_pos=0.5):
        self.M = M
        self.N = N
        self.p_pos = p_pos

    def generate(self, generator=None, device=None, dtype=None):
        u = torch.rand((self.M, self.N), generator=generator,
                       device=_device(generator, device),
                       dtype=dtype or DEFAULT_DTYPE)
        one = torch.ones_like(u)
        return torch.where(u < self.p_pos, one, -one) / math.sqrt(self.N)


class TernaryEnsemble(Ensemble):
    "iid {+1, 0, -1}/sqrt(N). Reference ternary_ensemble.py:5-33."

    def __init__(self, M, N, p_pos=0.33, p_neg=0.33):
        self.M = M
        self.N = N
        self.p_pos = p_pos
        self.p_neg = p_neg
        self.p_zero = 1.0 - p_pos - p_neg

    def generate(self, generator=None, device=None, dtype=None):
        u = torch.rand((self.M, self.N), generator=generator,
                       device=_device(generator, device),
                       dtype=dtype or DEFAULT_DTYPE)
        one = torch.ones_like(u)
        x = torch.where(u < self.p_neg, -one,
                        torch.where(u < self.p_neg + self.p_zero, 0 * one,
                                    one))
        return x / math.sqrt(self.N)


class RandomFeatureEnsemble(Ensemble):
    "X = f(WZ)/sqrt(N). Reference random_feature_ensemble.py:27-55."

    ACTIVATIONS = {
        "relu": lambda x: torch.clamp(x, min=0.0),
        "relu_zero_mean": lambda x: torch.clamp(x, min=0.0)
        - 1.0 / math.sqrt(2 * math.pi),
        "abs_zero_mean": lambda x: torch.abs(x) - math.sqrt(2.0 / math.pi),
        "abs": torch.abs,
        "tanh": torch.tanh,
        "sgn": torch.sign,
    }

    def __init__(self, M, N, f):
        self.M = M
        self.N = N
        self.f_name = f
        self.f = self.ACTIVATIONS[f]

    def generate(self, generator=None, device=None, dtype=None):
        kw = dict(generator=generator, device=_device(generator, device),
                  dtype=dtype or DEFAULT_DTYPE)
        Z = torch.randn((self.N, self.N), **kw) / math.sqrt(self.N)
        W = torch.randn((self.M, self.N), **kw)
        return self.f(W @ Z) / math.sqrt(self.N)


class ComplexUnitaryEnsemble(Ensemble):
    "Random phases e^{i phi}. Reference complex_unitary_ensemble.py:5-24."

    def __init__(self, M, N, scale=1):
        self.M = M
        self.N = N
        self.scale = scale

    def generate(self, generator=None, device=None, dtype=None):
        phi = torch.rand((self.M, self.N), generator=generator,
                         device=_device(generator, device),
                         dtype=dtype or DEFAULT_DTYPE)
        return torch.polar(torch.ones_like(phi), 2 * math.pi * phi)


ENSEMBLE_CLASSES = {
    "gaussian": GaussianEnsemble,
    "complex_gaussian": ComplexGaussianEnsemble,
    "rotation": RotationEnsemble,
    "unitary": UnitaryEnsemble,
    "binary": BinaryEnsemble,
    "ternary": TernaryEnsemble,
    "marchenko": MarchenkoPasturEnsemble,
    "random_feature": RandomFeatureEnsemble,
    "complex_unitary": ComplexUnitaryEnsemble,
}


def get_ensemble(ensemble_type, **kwargs):
    return ENSEMBLE_CLASSES[ensemble_type](**kwargs)


__all__ = ["Ensemble", "GaussianEnsemble", "ComplexGaussianEnsemble",
           "RotationEnsemble", "UnitaryEnsemble", "BinaryEnsemble",
           "TernaryEnsemble", "RandomFeatureEnsemble",
           "ComplexUnitaryEnsemble", "MarchenkoPasturEnsemble",
           "ENSEMBLE_CLASSES", "get_ensemble"]
