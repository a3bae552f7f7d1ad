"""Random matrix ensembles of the ported linear channels. Counterpart of
tramp_tpu/ensembles (``Ensemble``, ``GaussianEnsemble``, ``get_ensemble``);
``generate`` draws with a ``torch.Generator``."""
import math

import torch

from ..config import default_device, DEFAULT_DTYPE
from .marchenko_pastur_ensemble import MarchenkoPasturEnsemble


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
        device = device or (generator.device if generator is not None
                            else default_device())
        return torch.randn((self.M, self.N), generator=generator,
                           device=device,
                           dtype=dtype or DEFAULT_DTYPE) / math.sqrt(self.N)


ENSEMBLE_CLASSES = {
    "gaussian": GaussianEnsemble,
    "marchenko": MarchenkoPasturEnsemble,
}
#: ensembles of the JAX package not ported yet: they come with the
#: structured and complex channels
_WAITING = ("complex_gaussian", "rotation", "unitary", "binary", "ternary",
            "random_feature", "complex_unitary")


def get_ensemble(ensemble_type, **kwargs):
    if ensemble_type in _WAITING:
        raise NotImplementedError(
            f"ensemble {ensemble_type!r} is not ported yet (ROADMAP Queue 1 "
            "item 4)")
    return ENSEMBLE_CLASSES[ensemble_type](**kwargs)


__all__ = ["Ensemble", "GaussianEnsemble", "MarchenkoPasturEnsemble",
           "ENSEMBLE_CLASSES", "get_ensemble"]
