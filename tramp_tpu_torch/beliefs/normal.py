"""Normal belief: log-partition A and moments for N with natural params (a, b).
Counterpart of tramp_tpu/beliefs/normal.py."""
import math

import torch


def A(a, b):
    return 0.5 * (b**2 / a + torch.log(2.0 * math.pi / a))


def r(a, b):
    return b / a


def v(a, b):
    return 1.0 / a


def tau(a, b):
    return 1.0 / a + (b / a) ** 2
