"""The smooth activation channels, tramp_tpu_torch against tramp_tpu,
float64 on the CPU: ``ActivationChannel`` (tanh, sin, cos, erf) and
``TanhChannel``.

- The counterpart of tests/test_low_rank_activation.py:37-59: the tanh
  posteriors against scipy's adaptive quadrature at rtol 1e-6.
- Posteriors, messages and the elementwise variances (the SE integrands)
  against the JAX channel at rtol 1e-10, one instance and 3 lanes
  (messages ``(3, n)`` with precisions ``(3, 1)``; the quadrature nodes
  ride a trailing axis), and the second moment.
- The relu net of bench.py:1124-1157 with tanh in place of relu, N = 64:
  20 sweeps of EP against the JAX engine (every slot at rtol 1e-8), through
  the converter.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import channels as jch
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch.channels import ActivationChannel, TanhChannel, \
    get_channel

from torch_parity import assert_close, port_model

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def test_tanh_channel_vs_quadrature():
    from scipy.integrate import quad
    ch = TanhChannel()
    az, bz, ax, bx = 1.5, 0.7, 0.9, -0.4

    def belief(z):
        x = np.tanh(z)
        return np.exp(-0.5 * ax * x**2 + bx * x - 0.5 * az * z**2 + bz * z)

    lo, hi = bz / az - 10 / np.sqrt(az), bz / az + 10 / np.sqrt(az)
    Z = quad(belief, lo, hi)[0]
    rz_o = quad(lambda z: z * belief(z), lo, hi)[0] / Z
    rx_o = quad(lambda z: np.tanh(z) * belief(z), lo, hi)[0] / Z
    rz, _ = ch.compute_backward_posterior(_t(az), _t([bz]), _t(ax), _t([bx]))
    rx, _ = ch.compute_forward_posterior(_t(az), _t([bz]), _t(ax), _t([bx]))
    np.testing.assert_allclose(float(rz[0]), rz_o, rtol=1e-6)
    np.testing.assert_allclose(float(rx[0]), rx_o, rtol=1e-6)


FUNCS = ["tanh", "sin", "cos", "erf"]
METHODS = ("compute_forward_posterior", "compute_backward_posterior",
           "compute_forward_message", "compute_backward_message",
           "scalar_forward_variance", "scalar_backward_variance")


@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("func", FUNCS)
def test_activation_channel_against_jax(func, lanes):
    rng = np.random.RandomState(FUNCS.index(func))
    n = 17
    jc = jch.ActivationChannel(func)
    ch = ActivationChannel(func)
    shape = () if lanes is None else (lanes, 1)
    az, ax = rng.uniform(0.5, 3.0, shape), rng.uniform(0.2, 2.0, shape)
    lead = () if lanes is None else (lanes,)
    bz, bx = rng.randn(*lead, n), rng.randn(*lead, n)
    for method in METHODS:
        got = getattr(ch, method)(_t(az), _t(bz), _t(ax), _t(bx))
        got = got if isinstance(got, tuple) else (got,)
        for i in range(lanes or 1):
            pick = (lambda x: x) if lanes is None else (lambda x: x[i])
            want = getattr(jc, method)(
                float(np.ravel(az)[i]), jnp.asarray(pick(bz)),
                float(np.ravel(ax)[i]), jnp.asarray(pick(bx)))
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                g = g if lanes is None else g[i]
                assert_close(g.reshape(np.shape(w)), w, 1e-10,
                             what=f"{func} {method} lane {i}")
    if lanes:
        _, vx = ch.compute_forward_posterior(_t(az), _t(bz), _t(ax), _t(bx))
        assert vx.shape == (lanes, 1)
    assert_close(ch.second_moment(0.7), jc.second_moment(0.7), 1e-10)


def test_registry_and_converter():
    ch = get_channel("tanh")
    assert type(ch) is TanhChannel and ch.name == "tanh"
    x = ch.sample(None, _t([0.0, 1.0]))
    assert_close(x, np.tanh([0.0, 1.0]), 1e-15)
    from torch_parity import describe_factor
    from tramp_tpu_torch import convert
    port = convert.factor_from_description(
        describe_factor(jch.TanhChannel()), device="cpu", dtype=F64)
    assert type(port) is TanhChannel and port.func is torch.tanh


def test_tanh_net_ep_against_jax():
    N, M = 64, 32
    rng = np.random.RandomState(11)
    W = rng.randn(M, N) / np.sqrt(N)
    teacher = (JGaussBernoulliPrior(size=N, rho=0.25) @ jt.V(id="x")
               @ jch.LinearChannel(W, name="W") @ jt.V(id="z")
               @ jch.TanhChannel() @ jt.V(id="a")
               @ jch.GaussianChannel(var=1e-2) @ jt.O(id="y")).to_model()
    x0 = (rng.rand(N) < 0.25) * rng.randn(N)
    y = np.tanh(W @ x0) + 0.1 * rng.randn(M)
    j_student = teacher.to_observed({"y": jnp.asarray(y)})
    student = port_model(j_student)
    j_ep = jt.ExpectationPropagation(j_student)
    j_ep.iterate(max_iter=20, damping=0.1, tol=0.0)
    ep = tt.ExpectationPropagation(student).iterate(max_iter=20, damping=0.1,
                                                    tol=0.0)
    assert ep.n_iter == j_ep.n_iter == 20
    for s in range(ep.n_slots):
        for k in ("a", "b"):
            assert_close(ep.state[s][k], j_ep.state[s][k], 1e-8,
                         what=f"slot {s} {k}")
