"""Build the port's models and message states from the JAX package's
parameters, handed over as numpy arrays (so the port never imports jax).

A model is described as a dict:

- ``"nodes"``: the DAG's nodes in its insertion order, each a dict with
  ``"class"`` (the class name, the same in both packages) and either
  ``"id"`` (variables) or ``"data"`` / ``"meta"`` (factors: the values of
  the class's ``_data_fields``, as numpy arrays or numbers, and of its
  ``_meta_fields``);
- ``"edges"``: the DAG's edges as (source, target) indices into
  ``"nodes"``, in the DAG's edge order.

Rebuilding the DAG in that order reproduces the JAX model's topological
node order and edge (message-slot) order. A message state is a list of
``{"a", "b"}`` numpy dicts, one per slot, plus the spectral cache
``{str(node index): array}`` when the engine carries one. The JAX linear
channel's SVD factors travel with it: JAX's and torch's SVDs differ in
column signs, so recomputing them would change every message.
"""
import numpy as np

from .base import Factor
from .channels import (
    GaussianChannel, LinearChannel, SgnChannel, AbsChannel,
    AsymmetricAbsChannel, ReluChannel, LeakyReluChannel, HardTanhChannel,
    HardSigmoidChannel, SymmetricDoorChannel,
)
from .config import as_tensor
from .likelihoods import GaussianLikelihood
from .models import Model, ModelDAG
from .models.graph import DiGraph
from .priors import GaussBernoulliPrior
from .variables import SISOVariable, SILeafVariable

FACTOR_CLASSES = {cls.__name__: cls for cls in (
    GaussBernoulliPrior, LinearChannel, GaussianChannel, SgnChannel,
    AbsChannel, AsymmetricAbsChannel, ReluChannel, LeakyReluChannel,
    HardTanhChannel, HardSigmoidChannel, SymmetricDoorChannel,
    GaussianLikelihood,
)}
VARIABLE_CLASSES = {cls.__name__: cls for cls in (
    SISOVariable, SILeafVariable)}


def factor_from_description(desc, device=None, dtype=None):
    """A factor from its class name, data fields and meta fields. Arrays
    become buffers on ``device`` with ``dtype``; numbers stay floats."""
    name = desc["class"]
    if name not in FACTOR_CLASSES:
        raise NotImplementedError(f"factor {name} is not ported yet")
    cls = FACTOR_CLASSES[name]
    factor = cls.__new__(cls)
    Factor.__init__(factor)
    for field, value in desc["data"].items():
        if value is None or np.ndim(value) > 0:
            factor.register_buffer(
                field, None if value is None
                else as_tensor(np.array(value), device, dtype))
        else:
            setattr(factor, field, float(value))
    for field, value in desc["meta"].items():
        setattr(factor, field, value)
    return factor


def model_from_description(desc, device=None, dtype=None):
    "The port's Model of a described JAX model (see the module docstring)."
    nodes = []
    for d in desc["nodes"]:
        if "id" in d:
            if d["class"] not in VARIABLE_CLASSES:
                raise NotImplementedError(
                    f"variable {d['class']} is not ported yet")
            nodes.append(VARIABLE_CLASSES[d["class"]](id=d["id"]))
        else:
            nodes.append(factor_from_description(d, device, dtype))
    dag = DiGraph()
    for n in nodes:
        dag.add_node(n)
    for u, v in desc["edges"]:
        dag.add_edge(nodes[u], nodes[v])
    return Model(ModelDAG(dag))


def state_from_numpy(slots, cache=None, device=None, dtype=None):
    """A message state from per-slot ``{"a", "b"}`` numpy dicts and, for an
    engine with a spectral carry, the cache dict."""
    state = tuple({k: as_tensor(np.array(v), device, dtype)
                   for k, v in msg.items()} for msg in slots)
    if cache is not None:
        state += ({k: as_tensor(np.array(v), device, dtype)
                   for k, v in cache.items()},)
    return state
