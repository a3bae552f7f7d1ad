"""Sparse (spike-and-slab) belief. Counterpart of tramp_tpu/beliefs/sparse.py.
``eta`` is the prior's constant: a Python float, or one value per lane as a
tensor that broadcasts against ``a`` and ``b``."""
import torch

from . import normal


def A(a, b, eta):
    A_slab = normal.A(a, b)
    if not isinstance(eta, torch.Tensor):
        eta = torch.full_like(A_slab, eta)
    return torch.logaddexp(eta, A_slab)


def p(a, b, eta):
    "Probability of the slab component."
    return torch.sigmoid(normal.A(a, b) - eta)


def r(a, b, eta):
    return p(a, b, eta) * (b / a)


def v(a, b, eta):
    s = p(a, b, eta)
    return s / a + s * (1.0 - s) * (b / a) ** 2


def tau(a, b, eta):
    s = p(a, b, eta)
    return s / a + s * (b / a) ** 2
