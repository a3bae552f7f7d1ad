"""Random matrix ensembles of the ported linear channels. Counterpart of
tramp_tpu/ensembles; ``generate`` draws with a ``torch.Generator`` on its
device (None: the first card). The complex ensembles return complex
tensors whose parts have ``dtype``."""
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
    "unitary": UnitaryEnsemble,
    "marchenko": MarchenkoPasturEnsemble,
    "complex_unitary": ComplexUnitaryEnsemble,
}
#: ensembles of the JAX package not ported yet: they come with the
#: structured real channels (ROADMAP Queue 1 item 4c)
_WAITING = ("rotation", "binary", "ternary", "random_feature")


def get_ensemble(ensemble_type, **kwargs):
    if ensemble_type in _WAITING:
        raise NotImplementedError(
            f"ensemble {ensemble_type!r} is not ported yet (ROADMAP Queue 1 "
            "item 4c)")
    return ENSEMBLE_CLASSES[ensemble_type](**kwargs)


__all__ = ["Ensemble", "GaussianEnsemble", "ComplexGaussianEnsemble",
           "UnitaryEnsemble", "ComplexUnitaryEnsemble",
           "MarchenkoPasturEnsemble", "ENSEMBLE_CLASSES", "get_ensemble"]
