"""The beliefs of the remaining priors and likelihoods, tramp_tpu_torch
against tramp_tpu, float64 on the CPU, on the grids of tests/test_beliefs.py:
binary, exponential, mixture, positive (with its exponential-limit
expansion) and truncated (three kinds of interval).

Tolerances (torch_parity.assert_close: relative to each element, with a
floor of rtol times the array's largest finite magnitude):
- log-partitions, means and second moments: rtol 1e-12 (the same
  formulas);
- the variances of the positive and truncated beliefs, v0 (1 + g2 - g1^2),
  are differences of larger terms: 1e-12 times those terms' magnitude,
  v0 (1 + |g2| + g1^2), as tests/test_torch_factors.py holds the
  truncated-normal variance; their probabilities Phi(y) - Phi(x) to 1e-12
  absolutely; the binary variance 1 - tanh(b)^2 to 1e-15 absolutely.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu import beliefs as jbeliefs
from tramp_tpu.utils import truncated_normal as jtn

from tramp_tpu_torch import beliefs

from torch_parity import assert_close

RTOL = 1e-12
# tests/test_beliefs.py:16, and the positive belief's extra points
POINTS = [(1.0, 0.5), (2.0, -1.3), (0.7, 2.1), (5.0, 0.0), (0.05, 0.3)]
POSITIVE_POINTS = POINTS + [(1.0, -8.0), (0.3, 12.0), (1e-6, -2.0),
                            (2e-4, -0.9), (0.0, -3.0)]
BOUNDS = [(-1.0, 1.0), (0.5, 3.0), (-math.inf, 0.0)]


def _ab(points):
    a, b = np.array(points, dtype=np.float64).T
    return (torch.as_tensor(a), torch.as_tensor(b),
            jnp.asarray(a), jnp.asarray(b))


def _hold_variance(got, want, a, b, lo, hi):
    "The cancellation-scaled tolerance of v0 (1 + g2 - g1^2)."
    r0, v0 = jnp.asarray(b / a), jnp.asarray(1.0 / a)
    g1 = np.asarray(jtn._g1(r0, v0, lo, hi))
    g2 = np.asarray(jtn._g2(r0, v0, lo, hi))
    scale = np.asarray(v0) * (1 + np.abs(g2) + g1**2)
    np.testing.assert_array_less(np.abs(got.numpy() - np.asarray(want)),
                                 1e-12 * scale + 1e-300)


@pytest.mark.parametrize("b", [-3.0, -0.4, 0.0, 0.9, 25.0, 400.0])
def test_binary(b):
    bt, bj = torch.tensor([b, -b, 0.5 * b], dtype=torch.float64), \
        jnp.asarray([b, -b, 0.5 * b])
    for name in ("A", "r"):
        assert_close(getattr(beliefs.binary, name)(bt),
                     getattr(jbeliefs.binary, name)(bj), RTOL, what=name)
    # v = 1 - tanh(b)^2 is a difference of terms of size 1
    np.testing.assert_allclose(beliefs.binary.v(bt).numpy(),
                               np.asarray(jbeliefs.binary.v(bj)), rtol=0,
                               atol=1e-15)
    # a Python number (the prior's own constant) stays a number
    assert isinstance(beliefs.binary.A(b), float)
    assert beliefs.binary.A(b) == pytest.approx(
        float(jbeliefs.binary.A(b)), rel=RTOL)
    assert beliefs.binary.tau(bt) == 1.0


@pytest.mark.parametrize("b", [-0.5, -2.0, -7.3])
def test_exponential(b):
    bt = torch.tensor([b, 2 * b], dtype=torch.float64)
    bj = jnp.asarray([b, 2 * b])
    for name in ("A", "r", "v", "tau"):
        assert_close(getattr(beliefs.exponential, name)(bt),
                     getattr(jbeliefs.exponential, name)(bj), RTOL,
                     what=name)
    assert beliefs.exponential.A(b) == pytest.approx(
        float(jbeliefs.exponential.A(b)), rel=RTOL)


@pytest.mark.parametrize("a,b", POINTS)
def test_mixture(a, b):
    "tests/test_beliefs.py:85-99: three components on the leading axis."
    eta = np.array([0.2, -0.4, 1.1])
    aK = np.array([a, 2 * a, 0.5 * a])
    bK = np.array([b, b - 1.0, b + 0.5])
    # the components in front of a node axis, as the prior hands them
    nodes = np.linspace(-2.0, 2.0, 7)
    for shape_a, shape_b in (((3,), (3,)), ((3, 1), (3, 7))):
        A_ = aK.reshape(shape_a)
        B_ = (bK[:, None] + nodes).reshape(shape_b) if len(shape_b) > 1 \
            else bK
        E_ = eta.reshape(shape_a)
        for name in ("A", "p", "r", "v", "tau"):
            assert_close(
                getattr(beliefs.mixture, name)(*map(torch.as_tensor,
                                                    (A_, B_, E_))),
                getattr(jbeliefs.mixture, name)(*map(jnp.asarray,
                                                     (A_, B_, E_))),
                RTOL, what=name)


def test_positive():
    at, bt, aj, bj = _ab(POSITIVE_POINTS)
    for name in ("A", "r", "tau"):
        assert_close(getattr(beliefs.positive, name)(at, bt),
                     getattr(jbeliefs.positive, name)(aj, bj), RTOL,
                     what=name)
    a, b = at.numpy(), bt.numpy()
    tn = a > 0   # the truncated-normal route (a = 0 is the pure limit)
    got = beliefs.positive.v(at, bt)
    want = np.asarray(jbeliefs.positive.v(aj, bj))
    _hold_variance(got[tn], want[tn], a[tn], b[tn], 0.0, math.inf)
    assert_close(got[~tn], want[~tn], RTOL)
    np.testing.assert_allclose(beliefs.positive.p(at[tn], bt[tn]).numpy(),
                               np.asarray(jbeliefs.positive.p(aj, bj))[tn],
                               rtol=0, atol=1e-12)


def test_positive_exponential_limit_is_taken():
    "u = a/b^2 < 1e-3 takes the expansion on both sides."
    at, bt, aj, bj = _ab([(1e-6, -2.0), (2e-4, -0.9), (0.0, -3.0)])
    use = beliefs.positive._exp_limit(at, bt)[0]
    assert bool(use.all())
    for name in ("A", "r", "v"):
        assert_close(getattr(beliefs.positive, name)(at, bt),
                     getattr(jbeliefs.positive, name)(aj, bj), RTOL,
                     what=name)


@pytest.mark.parametrize("bounds", BOUNDS, ids=["finite", "positive_half",
                                                 "negative_half"])
def test_truncated(bounds):
    lo, hi = bounds
    at, bt, aj, bj = _ab(POINTS)
    for name in ("A", "r", "tau"):
        assert_close(getattr(beliefs.truncated, name)(at, bt, lo, hi),
                     getattr(jbeliefs.truncated, name)(aj, bj, lo, hi),
                     RTOL, what=name)
    _hold_variance(beliefs.truncated.v(at, bt, lo, hi),
                   jbeliefs.truncated.v(aj, bj, lo, hi), at.numpy(),
                   bt.numpy(), lo, hi)
    np.testing.assert_allclose(
        beliefs.truncated.p(at, bt, lo, hi).numpy(),
        np.asarray(jbeliefs.truncated.p(aj, bj, lo, hi)), rtol=0, atol=1e-12)


def test_beliefs_take_lanes():
    """A per-lane a (B, 1) against messages (B, n): each lane as its own
    call, to 1e-12."""
    rng = np.random.RandomState(2)
    a = torch.as_tensor(0.3 + rng.rand(3, 1))
    b = torch.as_tensor(2 * rng.randn(3, 5))
    for module, args in ((beliefs.positive, ()),
                         (beliefs.truncated, (-1.0, 0.5))):
        for name in ("A", "r", "v", "p"):
            got = getattr(module, name)(a, b, *args)
            assert got.shape == (3, 5)
            for i in range(3):
                assert_close(got[i], getattr(module, name)(a[i, 0], b[i],
                                                          *args),
                             1e-12, what=f"{module.__name__}.{name}")
