"""The float32 guard of the relative-r stop metric, against the JAX
package's tests/test_f32_convergence.py (ROADMAP Queue 3, parity gap 3).

A guard of 1e-300 underflows to 0 in float32: in an exactly symmetric
phase (zero-mean sign retrieval, where r stays exactly 0) the metric would
be 0/0 = NaN and disarm both the stop and the divergence rollback. The
port guards with ``torch.finfo(dtype).tiny``, as the JAX package guards
with ``jnp.finfo``. The instance is the JAX test's (its keys), carried
over by ``torch_parity.port_model`` in float32, the JAX side without x64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu_torch as tt

from torch_parity import port_model


def _symmetric_sgn_retrieval(N=64, alpha=1.5):
    """y = |Wx| with a zero-mean prior: r stays exactly 0 (an even
    likelihood). The JAX student (float32) and its port."""
    import tramp_tpu as jt
    from tramp_tpu.priors import GaussBernoulliPrior
    from tramp_tpu.channels import LinearChannel, AbsChannel
    with jax.enable_x64(False):
        M = int(alpha * N)
        W = jax.random.normal(jax.random.PRNGKey(0), (M, N)) / jnp.sqrt(N)
        teacher = (GaussBernoulliPrior(size=N, rho=0.5, mean=0.0)
                   @ jt.V(id="x") @ LinearChannel(W, name="W") @ jt.V(id="z")
                   @ AbsChannel() @ jt.O(id="y")).to_model()
        sample = teacher.sample(jax.random.PRNGKey(1))
        student = teacher.to_observed(
            {"y": jnp.asarray(sample["y"], jnp.float32)})
        return student, port_model(student, dtype=torch.float32)


def test_symmetric_phase_f32_early_stops():
    """Zero-mean sign retrieval in float32: r is exactly 0 every sweep; the
    loop stops on the stationary metric after as many sweeps as the JAX
    package's, not at max_iter on a NaN delta, at the uninformative fixed
    point v = the prior's second moment (rho = 0.5, var 1)."""
    import tramp_tpu as jt
    j_student, student = _symmetric_sgn_retrieval()
    with jax.enable_x64(False):
        jep = jt.ExpectationPropagation(j_student)
        jep.iterate(max_iter=200, damping=0.1)
    ep = tt.ExpectationPropagation(student).iterate(max_iter=200,
                                                    damping=0.1)
    assert ep.n_iter == jep.n_iter < 200
    d = ep.get_variable_data("x")
    assert d["r"].dtype == torch.float32 and bool((d["r"] == 0.0).all())
    assert bool(torch.isfinite(d["v"]).all())
    np.testing.assert_allclose(float(d["v"].mean()), 0.5, rtol=2e-2)


def test_delta_increase_finite_on_zero_metric_f32():
    "(delta, increase) stay finite, delta 0, for identically zero r."
    _, student = _symmetric_sgn_retrieval(N=16, alpha=1.0)
    eng = tt.ExpectationPropagation(student)
    z = [torch.zeros(16), torch.zeros(16)]
    delta, inc = eng._delta_increase("r", z, z)
    assert float(delta) == 0.0 and np.isfinite(float(inc))


def test_first_iteration_metric_nan_free():
    "b / a on the a = 0, b = 0 initial state is no NaN."
    _, student = _symmetric_sgn_retrieval(N=16, alpha=1.0)
    eng = tt.ExpectationPropagation(student)
    for m in eng._metric(eng.init_state(), "r"):
        assert m.dtype == torch.float32 and bool(torch.isfinite(m).all())


def test_rollback_stays_armed_in_f32():
    """A variable whose r jumps from 0 gives a finite, large increase, so
    the rollback comparison (``inc > max_increase``) can fire."""
    _, student = _symmetric_sgn_retrieval(N=16, alpha=1.0)
    eng = tt.ExpectationPropagation(student)
    new = [torch.full((16,), 2.0), torch.zeros(16)]
    old = [torch.zeros(16), torch.zeros(16)]
    delta, inc = eng._delta_increase("r", new, old)
    assert np.isfinite(float(inc)) and float(inc) > 0.2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_guard_is_dtype_aware(dtype):
    """finfo.tiny: nonzero in both dtypes (1e-300 underflows in float32),
    and the metric's guard keeps a zero r finite in each."""
    assert float(torch.finfo(dtype).tiny) > 0.0
    assert torch.tensor(1e-300, dtype=dtype).item() == (
        0.0 if dtype == torch.float32 else 1e-300)
    _, student = _symmetric_sgn_retrieval(N=16, alpha=1.0)
    eng = tt.ExpectationPropagation(student)
    z = [torch.zeros(16, dtype=dtype)] * 2
    assert float(eng._delta_increase("r", z, z)[0]) == 0.0
