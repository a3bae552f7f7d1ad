"""The lane axis: many instances of one model solved in one loop.

The JAX package batches with ``jax.vmap``; the port writes the batch out.
With B lanes every per-instance array gains a first axis of length B
(a message mean ``b`` of a length-n variable is ``(B, n)``) and every
per-instance scalar (a message precision ``a``, a mean variance) becomes
one value per lane that broadcasts against it: shape ``(B, 1)``, in general
``(B,)`` followed by one axis of length 1 per axis of the variable. Without
lanes nothing changes: precisions stay 0-d.

**The precision tells.** Code that must reduce "over the variable's own
axes" (the isotropic mean of a variance) cannot know from an array alone
whether ``(B, n)`` is B lanes or one two-dimensional variable, so it asks
the precision that travels with it: ``lane_count(a, like)`` is B when ``a``
has ``like``'s number of axes (at least two), ``like``'s first length, and
length 1 on every other axis; else None.
Where no message stands beside the precisions (a channel's variance, its
spectral means), ``precision_lanes`` reads any precision with axes as one
value per lane, since a precision without lanes is a number or 0-d.

Loop flags (done, converged, the iteration count) are 0-d without lanes and
``(B,)`` with them; ``select`` broadcasts such a flag against a state array.

**Hyperparameters.** A factor's numbers (``rho``, ``mean``, ``var``,
``alpha``, ``p_pos``, ``gamma``) are Python floats shared by all lanes, or
one value per lane as a tensor ``(B, 1)`` like a precision
(``stack_models`` makes them so where the models differ). Factor code uses them in tensor expressions, which take
both; ``log`` and ``sqrt`` here cover an expression of hyperparameters alone.
The state evolution's messages are precisions only, ``(B, 1)`` with lanes.
"""
import copy
import math

import torch

from . import config as _config


def lane_count(a, like):
    """B if the precision ``a`` is one value per lane of ``like`` (see the
    module docstring), else None."""
    if (isinstance(a, torch.Tensor) and a.ndim >= 2 and a.ndim == like.ndim
            and a.shape[0] == like.shape[0] and a.numel() == a.shape[0]):
        return a.shape[0]
    return None


def lane_mean(v, *precisions):
    """Mean of ``v`` over the variable's own axes, one value per lane: 0-d
    without lanes, ``(B, 1, ...)`` when one of ``precisions`` is per lane."""
    if any(lane_count(a, v) is not None for a in precisions):
        return v.mean(dim=tuple(range(1, v.ndim)), keepdim=True)
    return torch.mean(v)


def last_axis(x, reduce):
    """``reduce`` (torch.sum, torch.mean) over a spectrum: the whole of a
    one-dimensional ``x`` (0-d result), else the last axis, kept, so that
    the result is one value per lane."""
    return reduce(x) if x.ndim <= 1 else reduce(x, dim=-1, keepdim=True)


def per_lane(x, lanes):
    "``x`` as ``(B, -1)`` with lanes and as ``(-1,)`` without."
    return x.reshape(x.shape[0], -1) if lanes else x.reshape(-1)


def precision_lanes(*precisions):
    """B when one of ``precisions`` is one value per lane (a tensor with a
    first axis), else None: the rule where no message stands beside the
    precisions (a channel's variance), since a precision without lanes is a
    number or 0-d."""
    for a in precisions:
        if isinstance(a, torch.Tensor) and a.ndim > 0:
            return a.shape[0]
    return None


def spectral(a, B, d):
    """A precision (or second moment) as it broadcasts against a spectrum
    of ``d`` axes: itself without lanes, ``(B,) + (1,) * d`` with them."""
    if B is None or not isinstance(a, torch.Tensor):
        return a
    return a.reshape((B,) + (1,) * d)


def spectral_mean(x, B, d):
    """Mean over the ``d`` spectral axes: 0-d without lanes, ``(B,) + (1,)
    * d`` with them."""
    if B is None:
        return torch.mean(x)
    return x.mean(dim=tuple(range(-d, 0)), keepdim=True)


def like(x, a):
    """``x`` (0-d, or one value per lane) in the shape of the precision
    ``a`` it stands beside."""
    if isinstance(a, torch.Tensor) and a.ndim > 0:
        return x.reshape(a.shape)
    return x


def lane_sum(x, lanes):
    "Sum over everything but the lanes: 0-d, or ``(B,)``."
    return per_lane(x, lanes).sum(-1)


def select(flag, new, old):
    """``torch.where`` with a loop flag (0-d, or ``(B,)`` with lanes)
    broadcast from the left against the state arrays."""
    flag = flag.reshape(flag.shape + (1,) * (new.ndim - flag.ndim))
    return torch.where(flag, new, old)


def lane_values(x, B):
    """A per-lane scalar of a result, ``(B, 1, ...)``, as ``(B,)``, the shape
    the JAX package's batched solves return; anything else unchanged."""
    if B is not None and x.ndim >= 1 and x.numel() == B:
        return x.reshape(B)
    return x


def to_lanes(x, B):
    """An array without lanes, repeated for B lanes: ``(n,)`` becomes
    ``(B, n)`` and a 0-d scalar ``(B,)``. A copy, so that lanes can be
    written one by one."""
    return x.expand((B,) + tuple(x.shape)).contiguous()


def lane_precision(a, B, var_ndim):
    """A one-element precision as one value per lane of a variable with
    ``var_ndim`` axes of its own: shape ``(B, 1, ...)``."""
    return a.reshape(()).expand(B).reshape((B,) + (1,) * var_ndim).contiguous()


def log(x):
    "``log`` of a hyperparameter: a Python float, or a tensor per lane."
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def sqrt(x):
    "``sqrt`` of a hyperparameter: a Python float, or a tensor per lane."
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def hyperparameters(factor):
    """Names of the numeric hyperparameters of ``factor``: its data fields
    that are not registered buffers (``rho``, ``mean``, ``var``, ``alpha``,
    ``p_pos``, ``gamma``).
    Each is a Python number shared by all lanes, or one value per lane as a
    tensor ``(B, 1, ...)``."""
    return [f for f in type(factor)._data_fields if f not in factor._buffers]


def stack_models(models, device=None, dtype=None):
    """Stack same-structure models along a new first axis (the lanes).

    Takes the place of the JAX package's ``stack_pytrees``. The result is a
    structural copy of ``models[0]`` in which every registered buffer
    (operators, their SVD factors, observations) is the ``torch.stack`` of
    the models' buffers, and every numeric hyperparameter (``rho``, ``mean``,
    ``var``, ``alpha``, ``p_pos``, ``gamma``) that differs between the
    models is one value per lane, a tensor ``(B, 1)`` (``(B, 1, ...)`` for a
    prior of a variable with more axes); a hyperparameter that is equal in all models stays the
    Python number it was, unless nothing else would carry the lanes (models
    without buffers whose hyperparameters are all equal, as a grid of one
    point): then the first numeric hyperparameter is one value per lane, so
    that the batch has its B lanes, as every leaf of the JAX package's
    stacked pytree does. The structural fields (region bounds, sizes,
    names) are shared by the lanes and must be equal in all models; a
    difference raises. ``device`` and ``dtype`` are those of the
    hyperparameter tensors (None: those of the models' buffers, and for a
    model without any, as a state-evolution model, the first card and
    float64). To stack only some fields, use ``with_buffers``."""
    first = models[0]
    for m in models[1:]:
        if [type(n) for n in m.nodes] != [type(n) for n in first.nodes] \
                or m.edges != first.edges:
            raise ValueError("stack_models: the models differ in structure")
    replace, columns = {}, {}
    for i, factor in enumerate(first.factors):
        others = [m.factors[i] for m in models]
        for field in type(factor)._meta_fields:
            values = [getattr(f, field) for f in others]
            if any(v != values[0] for v in values):
                raise ValueError(
                    f"stack_models: {type(factor).__name__}.{field} differs "
                    f"between the models ({values}); only arrays and "
                    "numeric hyperparameters carry lanes")
        for field in hyperparameters(factor):
            values = [getattr(f, field) for f in others]
            if any(isinstance(v, torch.Tensor) for v in values):
                raise ValueError(
                    f"stack_models: {type(factor).__name__}.{field} already "
                    "carries lanes")
            if any(v != values[0] for v in values):
                size = getattr(factor, "size", None)
                ndim = len(size) if isinstance(size, tuple) else 1
                columns[i, field] = (values, ndim)
        for name, buf in factor._buffers.items():
            if buf is not None:
                replace[i, name] = torch.stack(
                    [f._buffers[name] for f in others])
    if not replace and not columns:
        key = next(((i, field) for i, factor in enumerate(first.factors)
                    for field in hyperparameters(factor)), None)
        if key is not None:
            i, field = key
            size = getattr(first.factors[i], "size", None)
            columns[key] = ([getattr(m.factors[i], field) for m in models],
                            len(size) if isinstance(size, tuple) else 1)
    if columns:
        like = next(iter(replace.values()), None)
        if device is None:
            device = like.device if like is not None \
                else _config.default_device()
        if dtype is None:
            dtype = like.dtype if like is not None else torch.float64
        for key, (values, ndim) in columns.items():
            replace[key] = torch.tensor(
                [float(v) for v in values], dtype=dtype,
                device=device).reshape((len(values),) + (1,) * ndim)
    return with_buffers(first, replace)


def with_buffers(model, replace):
    """A structural copy of ``model`` whose factors hold other buffers:
    ``replace`` maps ``(index into model.factors, field name)`` to the new
    tensor, for example ``{(2, "y"): ys}`` with ``ys`` of shape ``(B, M)``
    to give every lane its own observation under one shared operator, or
    ``{(0, "rho"): rhos}`` with ``rhos`` of shape ``(B, 1)`` to give every
    lane its own sparsity. The model's own factors are left as they are."""
    factors = {id(f): f for f in model.factors}
    copies = {}
    for (i, name), tensor in replace.items():
        factor = model.factors[i]
        if name not in factor._buffers and name not in hyperparameters(factor):
            raise ValueError(f"{type(factor).__name__} has no buffer or "
                             f"hyperparameter {name}")
        if id(factor) not in copies:
            twin = copy.copy(factor)
            twin.__dict__["_buffers"] = dict(factor._buffers)
            copies[id(factor)] = twin
        if name in factor._buffers:
            copies[id(factor)]._buffers[name] = tensor
        else:
            copies[id(factor)].__dict__[name] = tensor
    out = object.__new__(type(model))
    out.__dict__.update(model.__dict__)
    out.nodes = [copies.get(id(n), n) if id(n) in factors else n
                 for n in model.nodes]
    out.factors = [copies.get(id(f), f) for f in model.factors]
    # the model without lanes that the copy came from, the template against
    # which ``model_lanes`` tells the lanes (``parallel.shard_batched_model``)
    out.unstacked = getattr(model, "unstacked", model)
    return out


def model_lanes(model, template):
    """How a solver tells which buffers carry lanes: a buffer of ``model``
    carries lanes when it has one axis more than the same buffer of
    ``template``, the model the solver was built with (one instance), and a
    numeric hyperparameter carries lanes when it is a tensor ``(B, 1, ...)``.
    Returns B, the common length of those first axes, or None when nothing
    has lanes; raises when two fields disagree or a shape fits neither."""
    B = None
    for factor, ref in zip(model.factors, template.factors):
        for name in hyperparameters(factor):
            value = getattr(factor, name)
            if not isinstance(value, torch.Tensor) or value.ndim == 0:
                continue
            if value.numel() != value.shape[0] or (
                    B is not None and value.shape[0] != B):
                raise ValueError(
                    f"{type(factor).__name__}.{name} has shape "
                    f"{tuple(value.shape)}: need one value per lane, "
                    f"(B, 1, ...){'' if B is None else f' with B = {B}'}")
            B = value.shape[0]
        for name, buf in factor._buffers.items():
            want = ref._buffers.get(name)
            if buf is None or want is None:
                if (buf is None) != (want is None):
                    raise ValueError(f"{type(factor).__name__}.{name}: "
                                     "present in one model only")
                continue
            shape = _whole_shape(buf)
            if shape == tuple(want.shape):
                continue
            if shape[1:] != tuple(want.shape):
                raise ValueError(
                    f"{type(factor).__name__}.{name} has shape "
                    f"{tuple(buf.shape)}: need {tuple(want.shape)} or one "
                    "lane axis before it")
            if B is not None and buf.shape[0] != B:
                raise ValueError(
                    f"{type(factor).__name__}.{name} has {buf.shape[0]} "
                    f"lanes, another buffer {B}")
            B = buf.shape[0]
    return B


def _whole_shape(buf):
    """The shape of ``buf``, or of the whole operator where ``buf`` is this
    rank's block of one split over a mesh's model axis."""
    shard = getattr(buf, "model_shard", None)
    return tuple(buf.shape) if shard is None else shard.whole_shape(buf)
