"""Core node classes of the factor graph. Counterpart of tramp_tpu/base.py.

A *Factor* is an ``nn.Module``: its arrays (weights, observations) are
registered buffers, so ``.to(device)`` moves a factor, and its structural
fields (shapes, names, region bounds) and scalar hyperparameters are plain
attributes. Modules keep identity hashing, which the DAG algebra relies on.
All ``compute_*`` methods are plain tensor math; message bookkeeping
(cavity sums, damping) lives in the engines (tramp_tpu_torch/algos).

Behavioural contracts mirror the reference (tramp/base.py:236-464 for
factors, tramp/base.py:49-233 for variables).
"""
import torch
from torch import nn

from . import config


def inv(v):
    "Numerically safe inverse. Reference tramp/base.py:44-46."
    return 1.0 / torch.clamp(v, min=config.VMIN)


def compute_a_new(v, a, amin=config.AMIN, amax=config.AMAX):
    "Moment-matching precision update with clipping. Reference base.py:245-248."
    return torch.clamp(inv(v) - a, amin, amax)


def compute_ab_new(r, v, a, b, amin=config.AMIN, amax=config.AMAX):
    "Moment-matching natural-parameter update. Reference base.py:250-255."
    a_new = torch.clamp(inv(v) - a, amin, amax)
    b_new = r * (a + a_new) - b
    return a_new, b_new


class _Node:
    """Base for Factor/Variable; supports the ``@`` / ``+`` DAG algebra
    (reference tramp/base.py:57-63, 264-270)."""

    def __add__(self, other):
        from .models.dag_algebra import DAG
        return DAG(self) + other

    def __matmul__(self, other):
        from .models.dag_algebra import DAG
        return DAG(self) @ other

    def __repr__(self):
        fields = getattr(self, "_repr_fields", None)
        if fields is None:
            fields = list(self._data_fields) + list(self._meta_fields)

        def fmt(v):
            if isinstance(v, torch.Tensor) and v.ndim > 0:
                return f"<tensor {tuple(v.shape)}>"
            return repr(v)

        args = ", ".join(f"{f}={fmt(getattr(self, f, None))}" for f in fields)
        return f"{type(self).__name__}({args})"


class Variable(_Node):
    """Variable node: pure structural metadata (id + arity). Reference
    tramp/base.py:49 and tramp/variables/sub_variables.py."""

    _repr_fields = ("id", "n_prev", "n_next")

    def __init__(self, id, n_prev, n_next):
        self.id = id
        self.n_prev = n_prev
        self.n_next = n_next


class Factor(_Node, nn.Module):
    """Factor node base.

    Subclasses declare ``_data_fields`` (arrays, registered as buffers, and
    numeric hyperparameters) and ``_meta_fields`` (shapes, names, flags),
    the same split as the JAX package, which the converter
    (tramp_tpu_torch/convert.py) reads. They implement the EP part of the
    reference Factor contract (sample / compute_*_posterior /
    compute_*_message) and ``out_shape``, the shape of the variable they
    emit given the shapes of their inputs.
    """

    _data_fields = ()
    _meta_fields = ()
    n_prev = None  # number of input variables
    n_next = None  # number of output variables

    def __init__(self):
        nn.Module.__init__(self)
        self.id = None

    def out_shape(self, *shapes):
        "Shape of the emitted variable. Default: elementwise in the input."
        return tuple(shapes[0])
