"""Sparse (spike-and-slab) belief. Counterpart of tramp_tpu/beliefs/sparse.py.
``eta`` is a Python float (the prior's constant)."""
import torch

from . import normal


def A(a, b, eta):
    A_slab = normal.A(a, b)
    return torch.logaddexp(torch.full_like(A_slab, eta), A_slab)


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
