"""Fixed-node quadrature for the state-evolution ensemble averages.
Counterpart of tramp_tpu/utils/integration.py.

- Composite Gauss-Legendre nodes with the Gaussian density folded into the
  weights for expectations against a Gaussian measure, and
- a probit-transformed Gauss-Legendre rule for expectations restricted to an
  interval (it represents the region indicators of the piecewise-linear
  factors exactly).

Nodes and weights are numpy constants (``numpy.polynomial``), moved once per
(device, dtype). Every integrand ``f`` maps tensors to tensors elementwise.
After that first move a measure copies nothing from the host: a parameter
or a segment edge given as a number is filled in on the device
(``_on_device``, ``_edges``), so that a sweep of the batched solvers can be
captured as one CUDA graph (``parallel.solver``).

**Lanes** (tramp_tpu_torch/lanes.py). A parameter of a measure (``m``,
``s``, a covariance entry, a breakpoint) is one number, a Python float or a
0-d tensor, or one value per lane, ``(B, 1)``. The nodes take the axis after
the lane axis: ``f`` is called on ``(nodes,)`` without lanes and on
``(B, nodes)`` with them, so that a ``(B, 1)`` precision inside ``f``
broadcasts against its argument, and the sum runs over the node axis only:
the result is 0-d without lanes and ``(B, 1)`` with them. A two-dimensional
rule hands ``f`` its n x n grid flattened to n * n nodes (``grid_2d``,
``grid_2d_full``), and the segments of the boundary rules are flattened in
the same way. A nested rule (an inner rule at every node of an outer one,
as the likelihoods' measures have) hands ``f`` its outer and inner nodes
flattened into one node axis too (``flat_call``, ``inner_gaussian_measure``).

**Count.** ``nodes_evaluated`` adds up the integrand's evaluations of every
measure's sum, lanes x nodes a call (an inner rule's nodes counted at every
outer node), from the tensors' shapes on the host: it reads nothing from
the device. Read it before and after a solve.
"""
from functools import lru_cache

import numpy as np
import torch

from .. import config
from .special import norm_cdf

#: integration range in standard deviations, matching the reference's
#: quad(integrand, -10, 10) (tramp/utils/integration.py:27).
QUAD_RANGE = 10.0
#: default node counts, defined in config as in the JAX package
GH_NODES = config.GH_NODES
GL_NODES = config.GL_NODES

_INF = float("inf")

#: integrand evaluations of the measures' sums since the module was loaded
nodes_evaluated = 0


def _count(values):
    "Add the evaluations ``values`` holds to ``nodes_evaluated``."
    global nodes_evaluated
    nodes_evaluated += values.numel()


@lru_cache(maxsize=None)
def gauss_hermite(n=GH_NODES):
    """Nodes/weights (x, w) such that sum_i w_i f(x_i) = E[f(X)], X~N(0,1).
    Plain Gauss-Hermite converges slowly for saturating integrands; prefer
    ``std_normal_nodes``."""
    x, w = np.polynomial.hermite_e.hermegauss(n)
    w = w / np.sqrt(2.0 * np.pi)
    return x, w


@lru_cache(maxsize=None)
def gauss_legendre(n=GL_NODES):
    "Nodes/weights on [0, 1]."
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


@lru_cache(maxsize=None)
def composite_gauss_legendre(a, b, panels, order):
    "Composite Gauss-Legendre nodes/weights on [a, b]."
    u, w = np.polynomial.legendre.leggauss(order)
    edges = np.linspace(a, b, panels + 1)
    lo, hi = edges[:-1], edges[1:]
    h = 0.5 * (hi - lo)
    x = (lo[:, None] + h[:, None] * (u[None, :] + 1.0)).ravel()
    ww = (h[:, None] * w[None, :]).ravel()
    return x, ww


@lru_cache(maxsize=None)
def std_normal_nodes(n_panels=16, order=16, rng=QUAD_RANGE):
    """Nodes/weights for E[f(X)], X~N(0,1), over [-rng, rng]: composite
    Gauss-Legendre with the Gaussian density folded into the weights."""
    x, w = composite_gauss_legendre(-rng, rng, n_panels, order)
    w = w * np.exp(-0.5 * x**2) / np.sqrt(2.0 * np.pi)
    return x, w


@lru_cache(maxsize=None)
def _std_normal_grid(n_panels, order):
    """The flattened n x n product rule of ``std_normal_nodes``: (u1, u2, w)
    with u1 the slow index, as ``x[:, None]`` and ``x[None, :]`` raveled."""
    x, w = std_normal_nodes(n_panels, order)
    n = x.shape[0]
    return np.repeat(x, n), np.tile(x, n), np.outer(w, w).ravel()


@lru_cache(maxsize=None)
def _on(device, dtype, rule, *args):
    "The numpy constants of ``rule(*args)`` as tensors, moved once."
    return tuple(torch.as_tensor(a, device=device, dtype=dtype)
                 for a in rule(*args))


def rule_on(like, rule, *args):
    """The numpy nodes and weights of ``rule(*args)`` (a rule of this
    module) as tensors on ``like``'s device and dtype, moved once."""
    return _on(like.device, like.dtype, rule, *args)


def _on_device(x, device, dtype):
    """A measure parameter (a number or a tensor) as a tensor on ``device``
    in ``dtype``: a number is filled in there (``torch.full``), so that no
    parameter is copied from the host and a captured sweep can hold it."""
    if isinstance(x, (int, float)):
        return torch.full((), x, device=device, dtype=dtype)
    return torch.as_tensor(x, device=device, dtype=dtype)


def sqrt_like(x, like):
    """The square root of a measure parameter (a number or a tensor) as a
    tensor on ``like``'s device and dtype."""
    return torch.sqrt(_on_device(x, like.device, like.dtype))


def _like(*params):
    """(device, dtype, lanes) of a measure from its parameters: those of the
    first tensor among them (without any: the first card and float64);
    ``lanes`` when one of them has an axis."""
    tensors = [p for p in params if isinstance(p, torch.Tensor)]
    lanes = any(t.ndim > 0 for t in tensors)
    if not tensors:
        return config.default_device(), torch.float64, lanes
    return tensors[0].device, tensors[0].dtype, lanes


def _total(weighted, lanes):
    "Sum over the node axis: 0-d without lanes, ``(B, 1)`` with them."
    _count(weighted)
    return weighted.sum(-1, keepdim=True) if lanes else weighted.sum()


def gaussian_measure(m, s, f):
    """integral of N(x | m, s^2) f(x) over m +- 10 s.
    Reference integration.py:13-28."""
    device, dtype, lanes = _like(m, s)
    x, w = _on(device, dtype, std_normal_nodes)
    return _total(w * f(m + s * x), lanes)


def grid_2d(m1, s1, m2, s2, n_panels=10, order=10):
    """Nodes (x1, x2) and weights w of ``gaussian_measure_2d``, flattened:
    the measure of f is ``sum(w * f(x1, x2))`` over the last axis. x1 and x2
    have one shape, ``(n * n,)`` or ``(B, n * n)``."""
    device, dtype, _ = _like(m1, s1, m2, s2)
    u1, u2, w = _on(device, dtype, _std_normal_grid, n_panels, order)
    x1, x2 = torch.broadcast_tensors(m1 + s1 * u1, m2 + s2 * u2)
    return x1, x2, w


def gaussian_measure_2d(m1, s1, m2, s2, f, n_panels=10, order=10):
    """integral of N(x1|m1,s1^2) N(x2|m2,s2^2) f(x1, x2).
    Reference integration.py:31-47."""
    x1, x2, w = grid_2d(m1, s1, m2, s2, n_panels, order)
    return _total(w * f(x1, x2), _like(m1, s1, m2, s2)[2])


def grid_2d_full(mean, cov, n_panels=10, order=10):
    """Nodes (y1, y2) and weights w of ``gaussian_measure_2d_full``,
    flattened as in ``grid_2d``. The 2 x 2 Cholesky factor is written out,
    entry by entry, so that each entry may be one value per lane."""
    (c00, _), (c10, c11) = cov
    device, dtype, _ = _like(c00, c10, c11, mean[0], mean[1])
    L00 = torch.sqrt(_on_device(c00, device, dtype))
    L10 = c10 / L00
    L11 = torch.sqrt(c11 - L10 * L10)
    u1, u2, w = _on(device, dtype, _std_normal_grid, n_panels, order)
    y1, y2 = torch.broadcast_tensors(
        mean[0] + L00 * u1, mean[1] + L10 * u1 + L11 * u2)
    return y1, y2, w


def gaussian_measure_2d_full(mean, cov, f, n_panels=10, order=10):
    """integral of N((x1,x2) | mean, cov) f(x1, x2), full 2x2 covariance
    (Cholesky + independent standard normals). ``mean`` is a pair and
    ``cov`` a pair of pairs of numbers or per-lane tensors, or tensors of
    shape (2,) and (2, 2). Reference integration.py:50-73."""
    y1, y2, w = grid_2d_full(mean, cov, n_panels, order)
    (c00, _), (c10, c11) = cov
    return _total(w * f(y1, y2), _like(c00, c10, c11, mean[0], mean[1])[2])


def _cdf_bounds(m, s, zmin, zmax):
    lo = 0.0 if zmin == -_INF else norm_cdf((zmin - m) / s)
    hi = 1.0 if zmax == _INF else norm_cdf((zmax - m) / s)
    return lo, hi


def truncated_gaussian_measure(m, s, zmin, zmax, f, n=GL_NODES):
    """integral of N(z | m, s^2) f(z) over the interval [zmin, zmax].

    Probit change of variables z = m + s * Phi^{-1}(Phi(a) + u (Phi(b)-Phi(a)))
    makes the integrand smooth in u and represents the interval indicator
    exactly. zmin/zmax are Python floats (possibly +-inf). ``n`` is taken
    and not used, as in the JAX package (tramp_tpu/utils/integration.py
    :111-128): the rule is always 12 panels of 12 Gauss-Legendre nodes."""
    device, dtype, lanes = _like(m, s)
    m, s = (_on_device(v, device, dtype) for v in (m, s))
    lo, hi = _cdf_bounds(m, s, zmin, zmax)
    mass = hi - lo
    u, w = _on(device, dtype, composite_gauss_legendre, 0.0, 1.0, 12, 12)
    # clip away from 0/1 to keep ndtri finite
    p = torch.clamp(lo + u * mass, 1e-300, 1.0 - 1e-16)
    z = m + s * torch.special.ndtri(p)
    return mass * _total(w * f(z), lanes)


def _edges(lo, inner, hi):
    """Sorted segment edges along the last axis: lo, the inner points, hi.
    A bound that is a number is filled in on the device (``new_full``), so
    that no edge is copied from the host and a captured sweep can hold
    it."""
    shape = inner.shape[:-1] + (1,)

    def column(v):
        if isinstance(v, torch.Tensor):
            return v.expand(shape)
        return inner.new_full(shape, v)
    return torch.sort(torch.cat([column(lo), inner, column(hi)], -1), -1)[0]


def gaussian_measure_boundary(m, s, points, f, order=16, panels=8):
    """integral of N(x | m, s^2) f(x) over m +- 10 s with explicit quadrature
    segments split at the breakpoints ``points`` (``(P,)``, or ``(B, P)``
    with lanes).

    For integrands with boundary layers a fixed global rule loses the
    informative correction; here the segment edges are the breakpoints
    clipped into the +-10 sigma range and sorted per lane, so overlapping or
    out-of-range breakpoints degrade to zero-width (zero-weight) segments.
    Reference: the adaptive scipy.quad of tramp/utils/integration.py:27."""
    z = torch.clamp((points - m) / s, -QUAD_RANGE, QUAD_RANGE)
    return _xspace_segments(m, s, _edges(-QUAD_RANGE, z, QUAD_RANGE), f,
                            order, panels)


def truncated_gaussian_measure_boundary(m, s, zmin, zmax, points, f,
                                        order=12, panels=12):
    """``truncated_gaussian_measure`` with extra segment breakpoints, clipped
    into [zmin, zmax] (see gaussian_measure_boundary)."""
    lo, hi = _cdf_bounds(m, s, zmin, zmax)
    c = norm_cdf((points - m) / s)
    lo, hi = (_on_device(v, c.device, c.dtype) for v in (lo, hi))
    c = torch.clamp(c, min=lo, max=hi)
    return _probit_segments(m, s, _edges(lo, c, hi), f, order, panels)


def flat_call(f, *args):
    """``f`` on arguments of one shape ``(..., n, m)``, an inner rule's m
    nodes at each of an outer rule's n nodes: the last two axes are handed
    to ``f`` as one node axis, as the measures hand it their nodes (after
    the lane axis, where there is one), and restored in the result."""
    args = torch.broadcast_tensors(*args)
    shape = args[0].shape
    out = f(*(a.flatten(-2) for a in args))
    return torch.broadcast_to(out, shape[:-2] + (shape[-2] * shape[-1],)
                              ).reshape(shape)


def inner_axis(p):
    """A measure parameter (a number, 0-d, or ``(B, 1)`` with lanes) made to
    broadcast against an inner rule's nodes on a new last axis."""
    return p[..., None] if isinstance(p, torch.Tensor) and p.ndim else p


def inner_gaussian_measure(center, spread, g, *extra):
    """E over xi ~ N(0, 1) of ``g(center + spread * xi, *extra)`` by the
    ``std_normal_nodes`` rule, at every node of an outer rule: ``center``
    and ``extra`` have the outer nodes' shape (``(n,)``, or ``(B, n)`` with
    lanes), ``spread`` is a measure parameter; the result has the outer
    nodes' shape. The nested rule of the likelihoods' measures
    (reference: the inner ``std_normal_nodes`` sums of
    tramp_tpu/likelihoods/)."""
    xi, w = rule_on(center, std_normal_nodes)
    b = center[..., None] + inner_axis(spread) * xi
    vals = flat_call(g, b, *(e[..., None] for e in extra))
    _count(vals)
    return torch.sum(w * vals, -1)


def _probit_segments(m, s, c, f, order, panels):
    "Sum of probit-GL integrals over CDF segments given by sorted edges c."
    lanes = c.ndim > 1
    u, w = _on(c.device, c.dtype, composite_gauss_legendre, 0.0, 1.0, panels,
               order)
    lo = c[..., :-1, None]                      # (..., n_seg, 1)
    mass = (c[..., 1:] - c[..., :-1])[..., None]
    p = torch.clamp(lo + u * mass, 1e-300, 1.0 - 1e-16)
    x = m + s * torch.special.ndtri(p).flatten(-2)
    return _total((mass * w).flatten(-2) * f(x), lanes)


def _xspace_segments(m, s, z_edges, f, order, panels):
    """Sum of composite-GL integrals of N(x|m,s^2) f(x) over segments of
    standard-unit edges ``z_edges`` (sorted along the last axis), Gaussian
    density folded into the weights."""
    lanes = z_edges.ndim > 1
    u, w = _on(z_edges.device, z_edges.dtype, composite_gauss_legendre, 0.0,
               1.0, panels, order)
    lo = z_edges[..., :-1, None]                # (..., n_seg, 1)
    h = (z_edges[..., 1:] - z_edges[..., :-1])[..., None]
    z = lo + u * h                              # (..., n_seg, n_nodes)
    ww = h * w * torch.exp(-0.5 * z**2) / np.sqrt(2.0 * np.pi)
    return _total(ww.flatten(-2) * f(m + s * z.flatten(-2)), lanes)


def exponential_measure(m, f, n=GL_NODES):
    """integral of (1/m) exp(-x/m) f(x) over [0, 10] (the reference
    truncates at 10, integration.py:103-118), Gauss-Legendre on [0, 10]."""
    device, dtype, lanes = _like(m)
    u, w = _on(device, dtype, gauss_legendre, n)
    x = 10.0 * u
    return _total(10.0 * w * (1.0 / m) * torch.exp(-x / m) * f(x), lanes)
