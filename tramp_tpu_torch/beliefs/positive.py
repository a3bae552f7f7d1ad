"""Positive (half-line truncated normal) belief. Counterpart of
tramp_tpu/beliefs/positive.py.

Exponential limit: for b < 0 and u = a/b^2 -> 0 the tilted density
e^{b x - a x^2/2} on x > 0 degenerates to Exp(-b), and the truncated-normal
formulas lose the variance to cancellation there. A branchless second-order
expansion in u takes over below u < 1e-3 (tramp_tpu/beliefs/positive.py:3-28):

  Z    = (1/l) (1 - u + 3 u^2),        l = -b
  E[x] = (1/l) (1 - 2u + 10 u^2) + O(u^3)
  V[x] = (1/l^2) (1 - 6u + 50 u^2) + O(u^3)
"""
import math

import torch

from ..utils.truncated_normal import (
    truncated_normal_mean, truncated_normal_var, truncated_normal_logZ,
    truncated_normal_proba,
)

INF = math.inf

#: switch to the exponential-limit expansion below this u = a/b^2
_U_EXP = 1e-3


def _exp_limit(a, b):
    """(use_limit, u, lam, a_safe) with the inputs of the branch that is not
    taken replaced by harmless values."""
    use = (b < 0) & (a >= 0) & (a < _U_EXP * b**2)
    lam = -torch.where(use, b, -1.0)
    u = torch.where(use, a, 0.0) / lam**2
    return use, u, lam, torch.where(use, 1.0, a)


def A(a, b):
    use, u, lam, a_safe = _exp_limit(a, b)
    A_tn = truncated_normal_logZ(b / a_safe, 1.0 / a_safe, 0.0, INF)
    A_exp = -torch.log(lam) + torch.log1p(-u + 3.0 * u**2)
    return torch.where(use, A_exp, A_tn)


def r(a, b):
    use, u, lam, a_safe = _exp_limit(a, b)
    r_tn = truncated_normal_mean(b / a_safe, 1.0 / a_safe, 0.0, INF)
    r_exp = (1.0 - 2.0 * u + 10.0 * u**2) / lam
    return torch.where(use, r_exp, r_tn)


def v(a, b):
    use, u, lam, a_safe = _exp_limit(a, b)
    v_tn = truncated_normal_var(b / a_safe, 1.0 / a_safe, 0.0, INF)
    v_exp = (1.0 - 6.0 * u + 50.0 * u**2) / lam**2
    return torch.where(use, v_exp, v_tn)


def tau(a, b):
    return r(a, b) ** 2 + v(a, b)


def p(a, b):
    "Probability that x ~ N(b/a, 1/a) falls within R_+."
    return truncated_normal_proba(b / a, 1.0 / a, 0.0, INF)
