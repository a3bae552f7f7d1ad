"""bfloat16 message state (``config.STATE_BF16``) and pinned constant
messages (``config.PIN_CONSTANT_MESSAGES``), tramp_tpu_torch against
tramp_tpu on the CPU: the counterparts of tests/test_state_bf16.py.

bf16 state: the engine stores float32 ``b`` slots as bfloat16 after the
damped mix and upcasts them at every read, so all arithmetic stays float32
(tramp_tpu/algos/message_passing.py:278-300). Held here, as in the JAX
tests under ``jax.enable_x64(False)``:

- the dtypes of every slot, of the carried images and of every posterior
  after a sweep (torch would promote a bfloat16 operand silently, so a
  missing upcast shows only in a dtype);
- three sweeps of an N = 64 float32 GLM, each from the JAX package's state
  of the sweep before: ``b`` within one bfloat16 ulp of the JAX package's
  (the float32 values before the rounding differ by roundoff, so at most a
  tie goes the other way), ``a`` and the images at rtol 1e-5;
- the bf16 fixed point against the float32 one at the JAX test's 2e-2
  (r, v), 5e-2 in MSE;
- the relu net's sweeps: the kernels' wrappers refuse a bfloat16 input, so
  every read of the piecewise-linear factor must be upcast.

Pinning: the slot sets equal the JAX package's (the GLM: the likelihood's
slot and the cavity that only sums it; a Gaussian prior's GLM: two factor
slots), the carry leaves a linear factor with a pinned bx alone, the
pinned fixed point equals the unpinned one within the JAX tests'
tolerances (rtol 1e-4, atol 1e-9 and rtol 1e-6, atol 1e-10) and the JAX
package's pinned fixed point at rtol 1e-8 (float64), and a pinned engine's
checkpoint resumes in the other package (rtol 1e-8). A bfloat16 state does
not round-trip through the JAX package's ``.npz`` checkpoint (its
``load_state`` refuses the raw 2-byte records its ``save_state`` wrote), so
the port's ``save_state`` refuses one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import config as jconfig
from tramp_tpu.channels import GaussianChannel as JGaussianChannel
from tramp_tpu.channels import LinearChannel as JLinear
from tramp_tpu.channels import ReluChannel as JReluChannel
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior
from tramp_tpu.priors import GaussianPrior as JGaussianPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch import config

from torch_parity import assert_close, port_model, to_numpy

F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture
def bf16(monkeypatch):
    monkeypatch.setattr(config, "STATE_BF16", True)
    monkeypatch.setattr(jconfig, "STATE_BF16", True)


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(config, "PIN_CONSTANT_MESSAGES", True)
    monkeypatch.setattr(jconfig, "PIN_CONSTANT_MESSAGES", True)


def _glm(N, alpha=0.7, rho=0.3, noise_var=1e-2, seed=0, dtype=np.float32,
         relu=False, prior=None):
    """A JAX student (and the teacher's x) from numpy: GLM x -> W -> z
    [-> relu -> a] -> + noise -> y."""
    rng = np.random.RandomState(seed)
    M = int(alpha * N)
    W = (rng.randn(M, N) / np.sqrt(N)).astype(dtype)
    x = ((rng.rand(N) < rho) * rng.randn(N)).astype(dtype)
    z = W @ x
    if relu:
        z = np.maximum(z, 0)
    y = (z + np.sqrt(noise_var) * rng.randn(M)).astype(dtype)
    prior = prior or JGaussBernoulliPrior(size=N, rho=rho)
    m = prior @ jt.V(id="x") @ JLinear(jnp.asarray(W)) @ jt.V(id="z")
    if relu:
        m = m @ JReluChannel() @ jt.V(id="a")
    m = (m @ JGaussianChannel(var=noise_var) @ jt.O(id="y")).to_model()
    return m.to_observed({"y": jnp.asarray(y)}), x


def _port_state(jstate, n_slots):
    """A JAX engine state in the port's layout: bfloat16 slots stay
    bfloat16 (every such value is exact in float32 on the way)."""
    def t(v):
        out = torch.as_tensor(np.array(v, dtype=np.float32)
                              if v.dtype == jnp.bfloat16 else np.array(v))
        return out.to(BF16) if v.dtype == jnp.bfloat16 else out
    state = tuple({k: t(v) for k, v in msg.items()}
                  for msg in jstate[:n_slots])
    if len(jstate) > n_slots:
        state += ({k: t(v) for k, v in jstate[n_slots].items()},)
    return state


def _bf16_ulp(x):
    "One bfloat16 ulp at |x| (8 significant bits)."
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def test_bf16_state_carry_dtype(bf16):
    """After a sweep every b slot is bfloat16, every a slot float32, the
    carried images float32, as in the JAX package; every posterior, metric
    and readout is float32."""
    with jax.enable_x64(False):
        jmodel, _ = _glm(64)
        jep = jt.ExpectationPropagation(jmodel)
        jstate = jep._sweep(jmodel, jep.init_state(),
                            jep._damping_per_slot(0.1))
        model = port_model(jmodel, dtype=F32)
    ep = tt.ExpectationPropagation(model)
    state = ep.init_state()
    for msg in state[:ep.n_slots]:
        assert msg["b"].dtype == BF16 and msg["a"].dtype == F32
    state = ep._sweep(model, state, ep._damping_per_slot(0.1))
    for msg, jmsg in zip(state[:ep.n_slots], jstate[:jep.n_slots]):
        assert msg["b"].dtype == BF16 and jmsg["b"].dtype == jnp.bfloat16
        assert msg["a"].dtype == F32 and jmsg["a"].dtype == jnp.float32
    assert all(v.dtype == F32 for v in state[ep.n_slots].values())
    assert all(v.dtype == jnp.float32 for v in jstate[jep.n_slots].values())
    for vi in ep.variable_indices:
        post = ep._posterior(vi, state)
        assert post["a"].dtype == post["b"].dtype == F32
    for m in ep._metric(state, "r") + ep._metric(state, "v"):
        assert m.dtype == F32
    assert ep._all_finite(state).dtype == torch.bool
    ep.iterate(max_iter=3, damping=0.1)
    for data in ep.get_variables_data().values():
        assert data["r"].dtype == data["v"].dtype == F32
    for record in ep.get_edges_data(["a", "b"]):
        assert record["b"].dtype == np.float32
    trace = ep.run_trace(n_iter=2, damping=0.1, warm_start=True)
    assert all(v.dtype == F32 for v in trace.values())
    assert all(msg["b"].dtype == BF16 for msg in ep.state[:ep.n_slots])


def test_first_sweeps_against_jax(bf16):
    """Three damped sweeps of the N = 64 GLM, each from the JAX package's
    state before it: b within one bfloat16 ulp, a and the carried images at
    rtol 1e-5."""
    with jax.enable_x64(False):
        jmodel, _ = _glm(64)
        jep = jt.ExpectationPropagation(jmodel)
        jdamp = jep._damping_per_slot(0.1)
        jstates = [jep.init_state()]
        for _ in range(3):
            jstates.append(jep._sweep(jmodel, jstates[-1], jdamp))
        model = port_model(jmodel, dtype=F32)
    ep = tt.ExpectationPropagation(model)
    damp = ep._damping_per_slot(0.1)
    assert ep.spectral_factors == tuple(jep.spectral_factors)
    for k in range(3):
        got = ep._sweep(model, _port_state(jstates[k], ep.n_slots), damp)
        want = jstates[k + 1]
        for s in range(ep.n_slots):
            assert got[s]["b"].dtype == BF16
            g = got[s]["b"].double().numpy()
            w = np.asarray(want[s]["b"], dtype=np.float64)
            ulp = _bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
            assert (np.abs(g - w) <= ulp).all(), (k, s)
            assert_close(got[s]["a"], want[s]["a"], 1e-5,
                         what=f"sweep {k + 1} slot {s} a")
        for key, image in want[ep.n_slots].items():
            assert_close(got[ep.n_slots][key], image, 1e-5,
                         what=f"sweep {k + 1} image {key}")


def test_bf16_state_close_to_f32_fixed_point(monkeypatch):
    """tests/test_state_bf16.py::test_bf16_state_close_to_f32_fixed_point
    on the port (N = 256, 100 sweeps, damping 0.1): r and v within 2e-2 of
    the float32 fixed point, MSE within 5e-2; and v within 2e-2 of the JAX
    package's bf16 solve."""
    with jax.enable_x64(False):
        jmodel, x0 = _glm(256)
        monkeypatch.setattr(jconfig, "STATE_BF16", True)
        jep = jt.ExpectationPropagation(jmodel)
        jep.iterate(max_iter=100, damping=0.1)
        v_jax = float(jnp.mean(jep.get_variable_data("x")["v"]))
        model = port_model(jmodel, dtype=F32)

    def solve():
        ep = tt.ExpectationPropagation(model)
        ep.iterate(max_iter=100, damping=0.1)
        d = ep.get_variable_data("x")
        return d["r"].double().numpy(), float(d["v"].double().mean())

    r32, v32 = solve()
    monkeypatch.setattr(config, "STATE_BF16", True)
    rb, vb = solve()
    assert np.linalg.norm(rb - r32) / np.linalg.norm(r32) < 2e-2
    assert abs(vb - v32) / v32 < 2e-2
    mse32, mseb = np.mean((r32 - x0) ** 2), np.mean((rb - x0) ** 2)
    assert abs(mseb - mse32) / mse32 < 0.05
    assert abs(vb - v_jax) / v_jax < 2e-2


def test_relu_net_sweeps_upcast_before_the_kernels(bf16):
    """The relu net with bf16 state: its piecewise-linear factor's wrappers
    refuse bfloat16, so 20 sweeps (plain and adaptive damping) run only if
    every read is upcast; the state stays bfloat16 and finite."""
    with jax.enable_x64(False):
        jmodel, _ = _glm(64, alpha=0.5, relu=True)
        model = port_model(jmodel, dtype=F32)
    for damping in (0.1, "adaptive"):
        ep = tt.ExpectationPropagation(model)
        ep.iterate(max_iter=20 if damping == 0.1 else 3, damping=damping)
        assert ep.n_iter > 0
        assert all(msg["b"].dtype == BF16 and torch.isfinite(msg["b"]).all()
                   for msg in ep.state[:ep.n_slots])


def test_bf16_checkpoint_refused(bf16, tmp_path):
    """The JAX package writes a bfloat16 slot as raw 2-byte records that its
    own ``load_state`` refuses; the port's ``save_state`` refuses the state
    instead of inventing a format."""
    with jax.enable_x64(False):
        jmodel, _ = _glm(64)
        jep = jt.ExpectationPropagation(jmodel)
        jep.iterate(max_iter=2, damping=0.1)
        jep.save_state(tmp_path / "jax.npz")
        with pytest.raises(TypeError):
            jt.ExpectationPropagation(jmodel).load_state(tmp_path / "jax.npz")
        model = port_model(jmodel, dtype=F32)
    ep = tt.ExpectationPropagation(model).iterate(max_iter=2, damping=0.1)
    with pytest.raises(ValueError, match="bfloat16"):
        ep.save_state(tmp_path / "port.npz")


def _solve(engine_cls, model, max_iter=200):
    ep = engine_cls(model)
    ep.iterate(max_iter=max_iter, damping=0.1)
    return ep


@pytest.mark.parametrize("prior", ["gauss_bernoulli", "gaussian"])
def test_pinned_slots_and_fixed_point(pinned, prior):
    """The pinned slot sets are the JAX package's (the Gaussian prior pins
    its forward slot too), the linear factor with a pinned bx carries no
    image in either, the pinned fixed point is the unpinned one within the
    JAX tests' tolerances and the JAX package's pinned one at rtol 1e-8."""
    N = 256 if prior == "gauss_bernoulli" else 64
    jprior = JGaussianPrior(size=N) if prior == "gaussian" else None
    jmodel, _ = _glm(N, dtype=np.float64, prior=jprior,
                     alpha=0.7 if prior == "gauss_bernoulli" else 0.75)
    model = port_model(jmodel)
    # the converter makes arrays, not the device a prior builds its
    # constant message on: the one a user gives the prior
    model.factors[0].device, model.factors[0].dtype = "cpu", torch.float64
    jep = _solve(jt.ExpectationPropagation, jmodel)
    ep = _solve(tt.ExpectationPropagation, model)
    assert ep.pinned_factor == jep.pinned_factor
    assert ep.pinned_variable == jep.pinned_variable
    assert ep.pinned == jep.pinned and ep.pinned_factor
    assert len(ep.pinned_factor) == (2 if prior == "gaussian" else 1)
    assert ep.spectral_factors == tuple(jep.spectral_factors) == ()
    assert ep._pinned_linear == {2}
    assert ep.n_iter == jep.n_iter
    r = ep.get_variable_data("x")["r"]
    assert_close(r, jep.get_variable_data("x")["r"], 1e-8)
    config.PIN_CONSTANT_MESSAGES = False
    try:
        default = _solve(tt.ExpectationPropagation, model)
    finally:
        config.PIN_CONSTANT_MESSAGES = True
    assert not default.pinned and default.spectral_factors
    rtol, atol = (1e-4, 1e-9) if prior == "gauss_bernoulli" else (1e-6,
                                                                   1e-10)
    np.testing.assert_allclose(
        r.numpy(), default.get_variable_data("x")["r"].numpy(), rtol=rtol,
        atol=atol)


def test_pinned_update_dA(pinned):
    "A pinned slot's local Bethe change is 0, as in the JAX package."
    jmodel, _ = _glm(64, dtype=np.float64)
    ep = tt.ExpectationPropagation(port_model(jmodel))
    ep.iterate(max_iter=3, damping=0.1, update_dA=True)
    jep = jt.ExpectationPropagation(jmodel)
    jep.iterate(max_iter=3, damping=0.1, update_dA=True)
    assert set(ep.dA) == set(jep.dA)
    for s in ep.pinned:
        assert ep.dA[s] == 0.0 == jep.dA[s]
    for s, v in jep.dA.items():
        assert abs(ep.dA[s] - v) <= 1e-8 * (1 + abs(v)), s


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pinned_checkpoint_resumes_in_the_other_package(pinned, writer,
                                                        tmp_path):
    """A pinned engine's checkpoint after 5 sweeps has the same keys in
    both packages (no ``spec_*`` key: the linear factor's bx is pinned) and
    resumes in the other one to the writer's own resumed run (rtol 1e-8)."""
    jmodel, _ = _glm(64, dtype=np.float64)
    model = port_model(jmodel)
    jep = jt.ExpectationPropagation(jmodel)
    jep.iterate(max_iter=5, damping=0.1)
    ep = tt.ExpectationPropagation(model).iterate(max_iter=5, damping=0.1)
    jep.save_state(tmp_path / "jax.npz")
    ep.save_state(tmp_path / "port.npz")
    keys = set(np.load(tmp_path / "jax.npz").files)
    assert keys == set(np.load(tmp_path / "port.npz").files)
    assert not any(k.startswith("spec_") for k in keys)
    if writer == "jax":
        resumed = tt.ExpectationPropagation(model).load_state(
            tmp_path / "jax.npz")
        resumed.iterate(max_iter=200, damping=0.1, warm_start=True)
        jep.iterate(max_iter=200, damping=0.1, warm_start=True)
        got, want = resumed, jep
    else:
        resumed = jt.ExpectationPropagation(jmodel).load_state(
            tmp_path / "port.npz")
        resumed.iterate(max_iter=200, damping=0.1, warm_start=True)
        ep.iterate(max_iter=200, damping=0.1, warm_start=True)
        got, want = ep, resumed
    assert got.n_iter == want.n_iter
    assert_close(to_numpy(got.get_variable_data("x")["r"]),
                 want.get_variable_data("x")["r"], 1e-8)
