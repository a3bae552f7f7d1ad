"""The quadrature of the state evolution, tramp_tpu_torch against tramp_tpu,
float64 on the CPU: the node rules (equal arrays), and every measure of
utils/integration.py with a polynomial and an erf-like integrand, for one
instance and with lanes (the parameters one value per lane, ``(B, 1)``:
each lane must equal the JAX function on that lane's parameters).

Tolerance: rtol 1e-12 of the value (torch_parity.assert_close): the same
nodes and formulas; only the order of the sums over the nodes differs, and
the two-dimensional rules sum their grid flattened.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import erf as jerf

from tramp_tpu.utils import integration as jint

from tramp_tpu_torch.utils import integration as tint

from torch_parity import assert_close

RTOL = 1e-12
F64 = torch.float64
B = 3

INTEGRANDS_1D = {
    "poly": (lambda x: x**3 - 2.0 * x**2 + 0.5,) * 2,
    "erf": (lambda x: torch.erf(0.7 * x - 0.2) + 1.5,
            lambda x: jerf(0.7 * x - 0.2) + 1.5),
}
INTEGRANDS_2D = {
    "poly": (lambda x, y: x**2 * y + y**2 - 0.3 * x + 2.0,) * 2,
    "erf": (lambda x, y: torch.erf(x - 0.5 * y) + 0.1 * y + 2.0,
            lambda x, y: jerf(x - 0.5 * y) + 0.1 * y + 2.0),
}


def _lanes(values):
    "Per-lane values as the port takes them: (B, 1)."
    return torch.as_tensor(np.asarray(values), dtype=F64).reshape(-1, 1)


def _t(x):
    return torch.as_tensor(x, dtype=F64)


@pytest.mark.parametrize("rule,args", [
    ("gauss_hermite", ()), ("gauss_hermite", (11,)),
    ("gauss_legendre", ()), ("gauss_legendre", (7,)),
    ("composite_gauss_legendre", (-1.5, 2.0, 5, 6)),
    ("std_normal_nodes", ()), ("std_normal_nodes", (10, 10)),
])
def test_node_rules_are_the_reference_ones(rule, args):
    got, want = getattr(tint, rule)(*args), getattr(jint, rule)(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _check(port_fn, jax_fn, params, lanes):
    """``params``: list of B tuples of numbers. Without lanes the first
    tuple alone, as 0-d tensors; with lanes all, as (B, 1) columns."""
    if not lanes:
        got = port_fn(*[_t(p) for p in params[0]])
        assert got.shape == ()
        assert_close(got, jax_fn(*params[0]), RTOL)
        return
    got = port_fn(*[_lanes(col) for col in zip(*params)])
    assert got.shape == (B, 1)
    want = np.array([float(jax_fn(*p)) for p in params]).reshape(B, 1)
    assert_close(got, want, RTOL)


@pytest.mark.parametrize("lanes", [False, True], ids=["one", "lanes"])
@pytest.mark.parametrize("name", list(INTEGRANDS_1D))
def test_gaussian_measure(name, lanes):
    f, jf = INTEGRANDS_1D[name]
    params = [(0.3, 1.7), (-1.0, 0.4), (2.0, 3.0)]
    _check(lambda m, s: tint.gaussian_measure(m, s, f),
           lambda m, s: jint.gaussian_measure(m, s, jf), params, lanes)


@pytest.mark.parametrize("lanes", [False, True], ids=["one", "lanes"])
@pytest.mark.parametrize("name", list(INTEGRANDS_2D))
def test_gaussian_measure_2d(name, lanes):
    f, jf = INTEGRANDS_2D[name]
    params = [(0.3, 1.7, -0.2, 0.9), (0.0, 0.0, 1.0, 2.0),
              (-1.0, 0.5, 0.0, 1e-6)]
    _check(lambda *p: tint.gaussian_measure_2d(*p, f),
           lambda *p: jint.gaussian_measure_2d(*p, jf), params, lanes)


@pytest.mark.parametrize("lanes", [False, True], ids=["one", "lanes"])
@pytest.mark.parametrize("name", list(INTEGRANDS_2D))
def test_gaussian_measure_2d_full(name, lanes):
    """Full covariance, one of them nearly degenerate (the jitter of
    linear_region.py on a zero block)."""
    f, jf = INTEGRANDS_2D[name]
    # (mean_2, c00, c10, c11)
    params = [(0.4, 2.0, 0.6, 1.3), (0.0, 1e-12, 0.0, 0.7 + 1e-12),
              (-1.0, 0.5, -0.3, 0.9)]

    def port(m2, c00, c10, c11):
        return tint.gaussian_measure_2d_full(
            (0.0, m2), ((c00, c10), (c10, c11)), f)

    def ref(m2, c00, c10, c11):
        return jint.gaussian_measure_2d_full(
            jnp.array([0.0, m2]), jnp.array([[c00, c10], [c10, c11]]), jf)

    _check(port, ref, params, lanes)


def test_gaussian_measure_2d_full_takes_tensors_of_shape_2_and_2x2():
    f, jf = INTEGRANDS_2D["erf"]
    mean, cov = np.array([0.2, -0.1]), np.array([[1.5, 0.4], [0.4, 0.8]])
    got = tint.gaussian_measure_2d_full(_t(mean), _t(cov), f)
    assert_close(got, jint.gaussian_measure_2d_full(
        jnp.asarray(mean), jnp.asarray(cov), jf), RTOL)


@pytest.mark.parametrize("lanes", [False, True], ids=["one", "lanes"])
@pytest.mark.parametrize("zmin,zmax", [(-np.inf, 0.0), (0.0, np.inf),
                                       (-1.0, 1.0), (-np.inf, np.inf)])
@pytest.mark.parametrize("name", list(INTEGRANDS_1D))
def test_truncated_gaussian_measure(name, zmin, zmax, lanes):
    f, jf = INTEGRANDS_1D[name]
    params = [(0.3, 1.7), (-1.0, 0.4), (2.0, 3.0)]
    _check(lambda m, s: tint.truncated_gaussian_measure(m, s, zmin, zmax, f),
           lambda m, s: jint.truncated_gaussian_measure(m, s, zmin, zmax, jf),
           params, lanes)


# breakpoints: inside the range, overlapping, and outside it (clipped to
# zero-width segments)
POINTS = [(-0.5, 0.1, 0.4, 2.0), (1.0, 1.0, 1.0, 1.0),
          (-80.0, -70.0, 0.2, 90.0)]


@pytest.mark.parametrize("lanes", [False, True], ids=["one", "lanes"])
@pytest.mark.parametrize("name", list(INTEGRANDS_1D))
def test_gaussian_measure_boundary(name, lanes):
    f, jf = INTEGRANDS_1D[name]
    params = [(0.3, 1.7) + POINTS[0], (-1.0, 0.4) + POINTS[1],
              (2.0, 3.0) + POINTS[2]]

    def port(m, s, *pts):
        points = torch.cat([torch.atleast_1d(p) for p in pts], -1)
        return tint.gaussian_measure_boundary(m, s, points, f)

    def ref(m, s, *pts):
        return jint.gaussian_measure_boundary(m, s, jnp.array(pts), jf)

    _check(port, ref, params, lanes)


@pytest.mark.parametrize("lanes", [False, True], ids=["one", "lanes"])
@pytest.mark.parametrize("zmin,zmax", [(-np.inf, 0.5), (-1.0, 1.0)])
@pytest.mark.parametrize("name", list(INTEGRANDS_1D))
def test_truncated_gaussian_measure_boundary(name, zmin, zmax, lanes):
    f, jf = INTEGRANDS_1D[name]
    params = [(0.3, 1.7) + POINTS[0], (-1.0, 0.4) + POINTS[1],
              (2.0, 3.0) + POINTS[2]]

    def port(m, s, *pts):
        points = torch.cat([torch.atleast_1d(p) for p in pts], -1)
        return tint.truncated_gaussian_measure_boundary(
            m, s, zmin, zmax, points, f)

    def ref(m, s, *pts):
        return jint.truncated_gaussian_measure_boundary(
            m, s, zmin, zmax, jnp.array(pts), jf)

    _check(port, ref, params, lanes)


@pytest.mark.parametrize("lanes", [False, True], ids=["one", "lanes"])
@pytest.mark.parametrize("name", list(INTEGRANDS_1D))
def test_exponential_measure(name, lanes):
    f, jf = INTEGRANDS_1D[name]
    _check(lambda m: tint.exponential_measure(m, f),
           lambda m: jint.exponential_measure(m, jf),
           [(0.7,), (2.5,), (0.2,)], lanes)


def test_zero_width_segments_weigh_nothing():
    """All breakpoints far outside +-10 sigma: the clipped segments have no
    width, and the result is the plain rule's, finite."""
    f = INTEGRANDS_1D["erf"][0]
    m, s = _t(0.3), _t(1.7)
    points = _t([-1e6, -1e5, 1e5, 1e6])
    got = tint.gaussian_measure_boundary(m, s, points, f)
    assert bool(torch.isfinite(got))
    assert_close(got, tint.gaussian_measure(m, s, f), 1e-10)


def test_integrand_sees_one_node_axis_after_the_lanes():
    "f gets (nodes,) without lanes and (B, nodes) with them, 2-D rules too."
    seen = []

    def f(*xs):
        seen.append(tuple(xs[0].shape))
        assert all(x.shape == xs[0].shape for x in xs)
        return xs[0]

    one, col = _t(1.3), _lanes([1.0, 2.0, 3.0])
    cov = ((col, 0.1 * col), (0.1 * col, col + 1.0))
    tint.gaussian_measure(one, one, f)
    tint.gaussian_measure(col, one, f)
    tint.gaussian_measure_2d(one, one, one, one, f)
    tint.gaussian_measure_2d(0.0, col, one, one, f)
    tint.gaussian_measure_2d_full((0.0, col), cov, f)
    tint.gaussian_measure_boundary(col, one, torch.cat([col, col + 1], -1), f)
    n1, n2 = 16 * 16, 100 * 100
    assert seen == [(n1,), (B, n1), (n2,), (B, n2), (B, n2),
                    (B, 3 * 8 * 16)]
