"""The state evolution of the remaining priors, tramp_tpu_torch against
tramp_tpu, float64 on the CPU: the SE methods of the binary, Gaussian,
exponential, positive and Gaussian-mixture priors on the ax grid of
tests/test_torch_se_factors.py (0 ... 4e3), their measures
(``b_measure``, ``bx_measure``, ``beliefs_measure``, ``measure``) and the
BO / RS potentials, and hyperparameters per lane (``p_pos``, ``mean``,
``var``, and the mixture's component rows) against the same prior lane by
lane. The EP half is in tests/test_torch_priors.py.

Tolerances (torch_parity.assert_close):
- SE methods and measures: rtol 1e-9 (quadrature sums in another order);
- lanes against lane-by-lane calls, in the port: 1e-12.
A free energy that is 0 in exact arithmetic (ax = 0) is held to 1e-12
absolutely: both sides return roundoff there (the positive prior's
measure returns NaN at ax = 0 on both sides, and NaN matches NaN).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu_torch import priors
from tramp_tpu_torch.lanes import stack_models, hyperparameters

from test_torch_priors import PRIORS, _col, _pair, _t
from torch_parity import assert_close

F64 = torch.float64
SE_RTOL = 1e-9
AX = [0.0, 1e-3, 0.8, 30.0, 4e3]   # tests/test_torch_se_factors.py:51
# priors with the BO / RS measures (b_measure, bx_measure)
BO_PRIORS = ["binary", "gaussian", "positive", "mixture"]


@pytest.mark.parametrize("ax", AX)
@pytest.mark.parametrize("name", list(PRIORS))
def test_prior_se_methods(name, ax):
    port, ref = _pair(name)
    methods = ["compute_forward_error", "compute_forward_state_evolution",
               "compute_free_energy", "compute_mutual_information",
               "compute_forward_overlap"]
    for method in methods:
        got, want = getattr(port, method)(_t(ax)), getattr(ref, method)(ax)
        if ax == 0 and method in ("compute_free_energy",
                                  "compute_mutual_information"):
            # 0 up to roundoff; the positive prior's measure divides 0 by 0
            # there on both sides (NaN equals NaN here)
            np.testing.assert_allclose(float(got), float(want), rtol=0,
                                       atol=1e-12, err_msg=method)
            continue
        assert_close(got, want, SE_RTOL, what=method)


@pytest.mark.parametrize("name", BO_PRIORS)
def test_prior_bo_rs_measures(name):
    port, ref = _pair(name)
    ax, mx_hat, qx_hat, tx0_hat = 1.3, 0.7, 0.9, 0.4
    for measure in ("b_measure", "bx_measure"):
        got = getattr(port, measure)(
            _t(mx_hat), _t(qx_hat), _t(tx0_hat),
            lambda bx: port.scalar_forward_mean(_t(ax), bx) + 2.0)
        want = getattr(ref, measure)(
            mx_hat, qx_hat, tx0_hat,
            lambda bx: ref.scalar_forward_mean(ax, bx) + 2.0)
        assert_close(got, want, SE_RTOL, what=measure)
    for method, args in (("compute_forward_v_BO", (ax, tx0_hat)),
                         ("compute_potential_BO", (ax, tx0_hat)),
                         ("forward_second_moment_FG", (tx0_hat,)),
                         ("prior_log_partition_FG", (tx0_hat,))):
        got = getattr(port, method)(*map(_t, args))
        # the JAX mixture puts its components on (K, 1) for a scalar bx and
        # returns shape (1,) there; the port returns the scalar
        want = np.reshape(getattr(ref, method)(*args), np.shape(got))
        assert_close(got, want, SE_RTOL, what=method)
    for got, want in zip(
            port.compute_forward_vmq_RS(_t(ax), _t(mx_hat), _t(qx_hat), port,
                                        _t(tx0_hat)),
            ref.compute_forward_vmq_RS(ax, mx_hat, qx_hat, ref, tx0_hat)):
        assert_close(got, want, SE_RTOL)


@pytest.mark.parametrize("name", list(PRIORS))
def test_prior_beliefs_measure_and_measure(name):
    port, ref = _pair(name)
    for ax in (0.8, 30.0):
        assert_close(
            port.beliefs_measure(_t(ax), lambda bx: torch.tanh(bx) + 2.0),
            ref.beliefs_measure(ax, lambda bx: jnp.tanh(bx) + 2.0), SE_RTOL)
    assert_close(port.measure(lambda x: torch.cos(x) + x**2),
                 ref.measure(lambda x: jnp.cos(x) + x**2), SE_RTOL)


# hyperparameters per lane: (field, three values)
LANE_FIELDS = {
    "binary": {"p_pos": [0.1, 0.5, 0.8]},
    "gaussian": {"mean": [0.0, 0.4, -1.0], "var": [1.0, 1.7, 0.3]},
    "exponential": {"mean": [0.7, 1.0, 2.5]},
}
LANE_AX = [0.8, 30.0, 1e-3]


@pytest.mark.parametrize("name", list(LANE_FIELDS))
def test_prior_lanes_equal_single_calls(name):
    """stack_models turns the hyperparameters that differ into (B, 1)
    tensors; every method gives lane by lane what the prior of that lane's
    numbers gives, SE and EP."""
    import tramp_tpu_torch as tt
    fields = LANE_FIELDS[name]
    cls = getattr(priors, PRIORS[name][0])
    singles = [cls(size=1, device="cpu", dtype=F64,
                   **{f: v[i] for f, v in fields.items()}) for i in range(3)]
    models = [(p @ tt.O(id="x")).to_model() for p in singles]
    laned = stack_models(models, device="cpu").factors[0]
    assert set(hyperparameters(laned)) >= set(fields)
    for f in fields:
        assert getattr(laned, f).shape == (3, 1)
    for method in ("compute_forward_error", "compute_forward_state_evolution",
                   "compute_free_energy"):
        got = getattr(laned, method)(_col(LANE_AX))
        want = [float(getattr(p, method)(_t(a)))
                for p, a in zip(singles, LANE_AX)]
        assert got.shape == (3, 1)
        assert_close(got, np.reshape(want, (3, 1)), 1e-12, what=method)
    rng = np.random.RandomState(1)
    bx = _t(rng.randn(3, 20))
    ax = _col([1.0, 2.0, 0.5])
    r, v = laned.compute_forward_posterior(ax, bx)
    assert r.shape == (3, 20) and v.shape == (3, 1)
    for i, p in enumerate(singles):
        r_i, v_i = p.compute_forward_posterior(ax[i, 0], bx[i])
        assert_close(r[i], r_i, 1e-12)
        assert_close(v[i, 0], v_i, 1e-12)
        assert_close(laned.compute_log_partition(ax, bx)[i, 0],
                     p.compute_log_partition(ax[i, 0], bx[i]), 1e-12)


def test_mixture_lanes_are_rows_of_the_component_buffers():
    """With lanes the component buffers are (B, K), one row per lane
    (stack_models stacks them); the prior of a row equals the lane."""
    import tramp_tpu_torch as tt
    rows = [((0.3, 0.7), (-1.0, 0.5), (0.5, 1.5)),
            ((0.5, 0.5), (0.0, 2.0), (1.0, 0.2)),
            ((0.9, 0.1), (1.0, -1.0), (2.0, 1.0))]
    singles = [priors.GaussianMixturePrior(
        size=1, probs=p, means=m, vars=v, device="cpu", dtype=F64)
        for p, m, v in rows]
    laned = stack_models([(p @ tt.O(id="x")).to_model() for p in singles]
                         ).factors[0]
    assert laned.probs.shape == (3, 2)
    ax = _col(LANE_AX)
    for method in ("compute_forward_error", "compute_free_energy",
                   "compute_forward_state_evolution"):
        got = getattr(laned, method)(ax)
        want = [float(getattr(p, method)(ax[i, 0]))
                for i, p in enumerate(singles)]
        assert_close(got, np.reshape(want, (3, 1)), 1e-12, what=method)
    assert_close(laned.second_moment(),
                 np.reshape([float(p.second_moment()) for p in singles],
                            (3, 1)), 1e-15)
    mx, qx, tx0 = _col([0.7, 1.2, 3.0]), _col([0.9, 0.4, 2.0]), \
        _col([0.4, 0.1, 1.0])
    for measure in ("b_measure", "bx_measure"):
        got = getattr(laned, measure)(mx, qx, tx0, torch.cos)
        for i, p in enumerate(singles):
            assert_close(got[i, 0], getattr(p, measure)(
                mx[i, 0], qx[i, 0], tx0[i, 0], torch.cos), 1e-12)
    bx = _t(np.random.RandomState(3).randn(3, 16))
    r, v = laned.compute_forward_posterior(_col([1.0, 2.0, 0.5]), bx)
    for i, p in enumerate(singles):
        r_i, v_i = p.compute_forward_posterior(_t([1.0, 2.0, 0.5][i]), bx[i])
        assert_close(r[i], r_i, 1e-12)
        assert_close(v[i, 0], v_i, 1e-12)


