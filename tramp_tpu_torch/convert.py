"""Build the port's models and message states from the JAX package's
parameters, handed over as numpy arrays (so the port never imports jax).

A model is described as a dict:

- ``"nodes"``: the DAG's nodes in its insertion order, each a dict with
  ``"class"`` (the class name, the same in both packages) and either
  ``"id"``, ``"n_prev"`` and ``"n_next"`` (variables) or ``"data"`` / ``"meta"`` (factors: the values of
  the class's ``_data_fields``, as numpy arrays or numbers, and of its
  ``_meta_fields``; an ``ensemble`` is described by its class name and
  constructor keywords);
- ``"edges"``: the DAG's edges as (source, target) indices into
  ``"nodes"``, in the DAG's edge order.

Rebuilding the DAG in that order reproduces the JAX model's topological
node order and edge (message-slot) order. A message state is a list of
``{"a", "b"}`` numpy dicts, one per slot (``{"a"}`` alone for a
state-evolution state), plus the spectral cache
``{str(node index): array}`` when the engine carries one. The JAX linear
channels' SVD factors travel with them: JAX's and torch's SVDs differ in
column signs (column phases for a complex W), so recomputing them would
change every message. A factor with several inputs or outputs (sum,
duplicate, concat) is wired by its edges like any other; its variables are
the JAX model's SIMO/MISO classes. The JAX package stores a complex
operator as a packed real pair ``(2, ...)`` (real part, imaginary part);
the port keeps it as a complex tensor (a class's ``_packed_fields``).
The FFT channels (conv, differential, laplacian, blur, gradient) are
rebuilt from their filter and meta fields (``from_description``): the JAX
package's spectra are complex leaves or packed pairs, depending on its FFT
mode, and its ``packed`` flag has no counterpart here; neither has an
activation channel's function object, which the port looks up by name.
"""
import numpy as np
import torch

from .base import Factor, Variable
from .channels import (
    AnalyticalLinearChannel, MarchenkoPasturChannel, ComplexLinearChannel,
    UnitaryChannel, ModulusChannel, BiasChannel, SumChannel,
    DuplicateChannel, ConcatChannel, ReshapeChannel,
    GaussianChannel, LinearChannel, SgnChannel, AbsChannel,
    AsymmetricAbsChannel, ReluChannel, LeakyReluChannel, HardTanhChannel,
    HardSigmoidChannel, SymmetricDoorChannel, AnalyticAbsChannel,
    AnalyticReluChannel, ConvChannel, DifferentialChannel, LaplacianChannel,
    Blur1DChannel, Blur2DChannel, GradientChannel, DFTChannel,
    RotationChannel, ActivationChannel, TanhChannel, LowRankGramChannel,
    LowRankFactorization,
)
from .config import as_complex, as_tensor
from .ensembles import MarchenkoPasturEnsemble
from .likelihoods import (
    GaussianLikelihood, SgnLikelihood, AbsLikelihood, ModulusLikelihood,
    PiecewiseLinearLikelihood, ReluLikelihood, LeakyReluLikelihood,
    AsymmetricAbsLikelihood, HardTanhLikelihood, HardSigmoidLikelihood,
    SymmetricDoorLikelihood,
)
from .models import Model, ModelDAG
from .models.graph import DiGraph
from .priors import (
    GaussBernoulliPrior, GaussianPrior, BinaryPrior, GaussianMixturePrior,
    ExponentialPrior, PositivePrior, MAP_L1NormPrior, MAP_L21NormPrior,
    CommitteeBinaryPrior,
)
from .variables import (
    SISOVariable, SIMOVariable, MISOVariable, MILeafVariable,
    SILeafVariable, MORootVariable, SORootVariable,
)

FACTOR_CLASSES = {cls.__name__: cls for cls in (
    GaussBernoulliPrior, GaussianPrior, BinaryPrior, GaussianMixturePrior,
    ExponentialPrior, PositivePrior, MAP_L1NormPrior, MAP_L21NormPrior,
    CommitteeBinaryPrior,
    LinearChannel, GaussianChannel, SgnChannel, AbsChannel,
    AsymmetricAbsChannel, ReluChannel, LeakyReluChannel, HardTanhChannel,
    HardSigmoidChannel, SymmetricDoorChannel, MarchenkoPasturChannel,
    AnalyticalLinearChannel, AnalyticAbsChannel, AnalyticReluChannel,
    ComplexLinearChannel, UnitaryChannel, ModulusChannel, BiasChannel,
    SumChannel, DuplicateChannel, ConcatChannel, ReshapeChannel,
    ConvChannel, DifferentialChannel, LaplacianChannel, Blur1DChannel,
    Blur2DChannel, GradientChannel, DFTChannel, RotationChannel,
    ActivationChannel, TanhChannel, LowRankGramChannel, LowRankFactorization,
    GaussianLikelihood, SgnLikelihood, AbsLikelihood, ModulusLikelihood,
    PiecewiseLinearLikelihood, ReluLikelihood, LeakyReluLikelihood,
    AsymmetricAbsLikelihood, HardTanhLikelihood, HardSigmoidLikelihood,
    SymmetricDoorLikelihood,
)}
ENSEMBLE_CLASSES = {"MarchenkoPasturEnsemble": MarchenkoPasturEnsemble}
#: meta fields of the JAX package that the port has no use for: the FFT
#: mode of the spectral channels, an activation's function object
_JAX_ONLY_META = ("packed", "_func")
VARIABLE_CLASSES = {cls.__name__: cls for cls in (
    SISOVariable, SIMOVariable, MISOVariable, MILeafVariable,
    SILeafVariable, MORootVariable, SORootVariable)}


def factor_from_description(desc, device=None, dtype=None):
    """A factor from its class name, data fields and meta fields. Arrays
    become buffers on ``device`` with ``dtype``; numbers stay floats."""
    name = desc["class"]
    if name not in FACTOR_CLASSES:
        raise NotImplementedError(f"factor {name} is not ported yet")
    cls = FACTOR_CLASSES[name]
    meta = {k: v for k, v in desc["meta"].items() if k not in _JAX_ONLY_META}
    if hasattr(cls, "from_description"):
        return cls.from_description(desc["data"], meta, device, dtype)
    factor = cls.__new__(cls)
    Factor.__init__(factor)
    packed = getattr(cls, "_packed_fields", ())
    for field, value in desc["data"].items():
        if field in packed:
            pair = torch.as_tensor(np.array(value))
            factor.register_buffer(
                field, as_complex(torch.complex(pair[0], pair[1]), device,
                                  dtype))
        elif value is None or np.ndim(value) > 0:
            factor.register_buffer(
                field, None if value is None
                else as_tensor(np.array(value), device, dtype))
        else:
            setattr(factor, field, float(value))
    for field, value in meta.items():
        if field == "ensemble":
            # {"class": name, **constructor keywords}
            kw = dict(value)
            value = ENSEMBLE_CLASSES[kw.pop("class")](**kw)
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
            # the arity comes with the description: a SIMO, MISO or
            # multi-input leaf variable takes its count in the constructor
            cls = VARIABLE_CLASSES[d["class"]]
            var = cls.__new__(cls)
            Variable.__init__(var, d["id"], d["n_prev"], d["n_next"])
            nodes.append(var)
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
