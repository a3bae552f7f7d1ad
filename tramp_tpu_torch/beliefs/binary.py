"""Binary (+-1 spin) belief. Counterpart of tramp_tpu/beliefs/binary.py.
``b`` is a tensor, or a Python number where the prior's own constant is
meant (then so is the result)."""
import math

import torch


def A(b):
    "ln 2 cosh(b), overflow-safe."
    if not isinstance(b, torch.Tensor):
        return abs(b) + math.log1p(math.exp(-2.0 * abs(b)))
    return torch.logaddexp(b, -b)


def r(b):
    return torch.tanh(b)


def v(b):
    return 1.0 - torch.tanh(b) ** 2


def tau(b):
    return 1.0
