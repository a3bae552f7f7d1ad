"""Exponential belief (b < 0). Counterpart of
tramp_tpu/beliefs/exponential.py. ``b`` is a tensor or a Python number."""
from ..lanes import log


def A(b):
    return -log(-b)


def r(b):
    return -1.0 / b


def v(b):
    return 1.0 / b**2


def tau(b):
    return 2.0 / b**2
