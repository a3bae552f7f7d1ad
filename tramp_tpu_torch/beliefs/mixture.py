"""Gaussian-mixture belief with K components along the leading axis.
Counterpart of tramp_tpu/beliefs/mixture.py. The component axis comes
first, before the lane axis where there is one: ``(K, ...)``."""
import torch

from . import normal


def A(a, b, eta):
    xi = eta + normal.A(a, b)
    return torch.logsumexp(xi, dim=0)


def p(a, b, eta):
    xi = eta + normal.A(a, b)
    return torch.softmax(xi, dim=0)


def r(a, b, eta):
    s = p(a, b, eta)
    return torch.sum(s * normal.r(a, b), dim=0)


def v(a, b, eta):
    s = p(a, b, eta)
    r_ = normal.r(a, b)
    vs = torch.sum(s * normal.v(a, b), dim=0)
    # pairwise dispersion term: 0.5 sum_kl s_k s_l (r_k - r_l)^2
    m1 = torch.sum(s * r_, dim=0)
    m2 = torch.sum(s * r_**2, dim=0)
    Dr = m2 - m1**2
    return Dr + vs


def tau(a, b, eta):
    s = p(a, b, eta)
    return torch.sum(s * normal.tau(a, b), dim=0)
