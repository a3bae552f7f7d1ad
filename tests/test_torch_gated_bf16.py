"""The convergence-gated two-phase solves (``solve_gated_bf16``,
``solve_batch_gated_bf16``), tramp_tpu_torch against tramp_tpu on the CPU:
the counterparts of tests/test_parallel.py:278-318 and :375-402.

Phase 1 sweeps with the message state stored in bfloat16 to the coarse tol
(5e-3 for stop kind "r", 1e-5 for "v": the JAX package's API values),
phase 2 sweeps in float32 from that state, upcast, to the solver's tol
(tramp_tpu/parallel/solver.py:183-318). Held, on an N = 200 float32 GLM:

- both phases ran, the coarse stop fired and the polish converged, in both
  packages; each phase's iteration count within 2 of the JAX package's
  (float32 sums in another order can move a stop by an iteration);
- the gated fixed point's mean v within 1e-3 of the single-phase float32
  solve's for stop kind "r" (tests/test_parallel.py:305); for kind "v",
  whose tol bounds the change of a sweep and not the distance to the fixed
  point, within 1e-3 of the JAX package's gated solve;
- every lane of a 4-lane batch converges in the polish, with v within 1e-3
  of the JAX package's batch; the lanes' single gated solves count within
  2 of the JAX package's. A lane's count in a batch is not held: the bf16
  phase amplifies the GEMM's other order of summation, and the JAX
  package's own batch and single solves of one lane differ by 7 sweeps
  (55 and 62, lane 0 here);
- with ``config.STATE_BF16`` already on, the polish still stores float32
  and converges (tests/test_parallel.py:375-402), to the same bits as
  without it, and the switch is set back;
- ``SESolver`` inherits both: with no ``b`` slots its two phases are two
  plain float64 runs, whose v is the JAX package's at rtol 1e-10 and whose
  counts are its own.

The JAX side of the float32 cases runs under ``jax.enable_x64(False)``, as
tests/test_state_bf16.py does: with x64 on, the precisions it derives from
Python numbers (the likelihood's 1/var) are float64, so its float32 model
sweeps a mixed state, whose bfloat16 trajectory is another one (kind "v"'s
coarse stop came 6 sweeps earlier there).
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
from tramp_tpu.parallel import EPSolver as JEPSolver
from tramp_tpu.parallel import SESolver as JSESolver
from tramp_tpu.parallel import stack_pytrees
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch import config
from tramp_tpu_torch.parallel import EPSolver, SESolver, stack_models

from torch_parity import port_model

N, M = 200, 120
SOLVE = dict(damping=0.1, max_iter=500, tol=1e-6)
V_RTOL = 1e-3
N_ITER_SLACK = 2


def _students(seeds):
    """JAX students of the float32 GLM of tests/test_parallel.py:289-296,
    one per seed of the observation, made with numpy."""
    rng = np.random.RandomState(0)
    W = (rng.randn(M, N) / np.sqrt(N)).astype(np.float32)
    teacher = (JGaussBernoulliPrior(size=N, rho=0.3) @ jt.V(id="x")
               @ JLinear(jnp.asarray(W)) @ jt.V(id="z")
               @ JGaussianChannel(var=1e-2) @ jt.O(id="y")).to_model()
    out = []
    for seed in seeds:
        r = np.random.RandomState(seed)
        x = (r.rand(N) < 0.3) * r.randn(N)
        y = (W @ x + 0.1 * r.randn(M)).astype(np.float32)
        out.append(teacher.to_observed({"y": jnp.asarray(y)}))
    return out


def _v(post):
    return float(np.mean(np.asarray(post["x"]["v"], dtype=np.float64)))


@pytest.mark.parametrize("stop_kind", ["r", "v"])
def test_solve_gated_bf16_against_jax(stop_kind):
    kw = dict(SOLVE, stop_kind=stop_kind)
    with jax.enable_x64(False):
        (jmodel,) = _students([1])
        model = port_model(jmodel, dtype=torch.float32)
        jpost, _, jconv, jinfo = JEPSolver(jmodel, **kw).solve_gated_bf16(
            jmodel)
    solver = EPSolver(model, **kw)
    post_f32, _, conv_f32 = solver.solve_info(model)
    post, n_total, conv, info = solver.solve_gated_bf16(model)
    assert bool(conv_f32) and bool(conv) and bool(jconv)
    assert info["coarse_fired"] and jinfo["coarse_fired"]
    assert info["n_iter_bf16"] > 0 and info["n_iter_f32"] > 0
    assert n_total == info["n_iter_bf16"] + info["n_iter_f32"]
    for key in ("n_iter_bf16", "n_iter_f32"):
        assert abs(info[key] - jinfo[key]) <= N_ITER_SLACK, (info, jinfo)
    assert post["x"]["r"].dtype == torch.float32
    if stop_kind == "r":
        assert abs(_v(post) - _v(post_f32)) / _v(post_f32) < V_RTOL
    assert abs(_v(post) - _v(jpost)) / _v(jpost) < V_RTOL
    assert solver._coarse_default() == (5e-3 if stop_kind == "r" else 1e-5)
    assert config.STATE_BF16 is None


def test_solve_batch_gated_bf16_against_jax():
    "Every lane of a 4-lane batch converges in the float32 polish."
    with jax.enable_x64(False):
        jmodels = _students([10, 11, 12, 13])
        models = [port_model(m, dtype=torch.float32) for m in jmodels]
        jsolver = JEPSolver(jmodels[0], **SOLVE)
        jpost, jn, jconv = jsolver.solve_batch_gated_bf16(
            stack_pytrees(jmodels))
        jsingle = [jsolver.solve_gated_bf16(m)[1] for m in jmodels]
    solver = EPSolver(models[0], **SOLVE)
    post, n_iter, conv = solver.solve_batch_gated_bf16(stack_models(models))
    assert conv.shape == n_iter.shape == (4,)
    assert bool(conv.all()) and np.asarray(jconv).all()
    single = [solver.solve_gated_bf16(m)[1] for m in models]
    assert (np.abs(np.subtract(single, jsingle)) <= N_ITER_SLACK).all()
    assert post["x"]["r"].shape == (4, N)
    v, jv = post["x"]["v"].double().numpy(), np.asarray(jpost["x"]["v"])
    assert (np.abs(v - jv) / jv < V_RTOL).all()


def test_gated_polish_stores_float32_under_ambient_state_bf16(monkeypatch):
    """With ``config.STATE_BF16`` on before the call, the polish stores
    float32 and converges, as in the JAX package, to the bits of the call
    without it; the switch is set back after each phase."""
    with jax.enable_x64(False):
        (jmodel,) = _students([1])
        model = port_model(jmodel, dtype=torch.float32)
    plain = EPSolver(model, **SOLVE).solve_gated_bf16(model)
    monkeypatch.setattr(config, "STATE_BF16", True)
    monkeypatch.setattr(jconfig, "STATE_BF16", True)
    solver = EPSolver(model, **SOLVE)
    seen = []
    run = solver._run

    def spy(model, state, stop=None, tol=None):
        out = run(model, state, stop, tol)
        seen.append((config.STATE_BF16, out[1][0]["b"].dtype))
        return out
    solver._run = spy
    post, n_total, conv, info = solver.solve_gated_bf16(model)
    assert seen == [(True, torch.bfloat16), (False, torch.float32)]
    assert config.STATE_BF16 is True
    assert bool(conv) and info["coarse_fired"]
    assert info["n_iter_f32"] < SOLVE["max_iter"]
    assert info == plain[3] and torch.equal(post["x"]["r"],
                                            plain[0]["x"]["r"])
    with jax.enable_x64(False):
        _, _, jconv, jinfo = JEPSolver(jmodel, **SOLVE).solve_gated_bf16(
            jmodel)
    assert bool(jconv) and jinfo == info


def test_se_solver_gated_phases_are_plain():
    """``SESolver`` inherits the gated solves; SE carries precisions only,
    so both phases run in float64: v is the JAX package's, and so is each
    phase's count."""
    kw = dict(alpha=0.5, prior_type="gauss_bernoulli",
              output_type="gaussian", prior_rho=0.25, output_var=1e-2)
    jmodel = jt.glm_state_evolution(**kw)
    model = tt.glm_state_evolution(**kw)
    jpost, jn, jconv, jinfo = JSESolver(jmodel, tol=1e-10).solve_gated_bf16(
        jmodel)
    solver = SESolver(model, tol=1e-10, device="cpu")
    post, n, conv, info = solver.solve_gated_bf16(model)
    assert bool(conv) and bool(jconv)
    assert info == jinfo and n == jn
    assert info["coarse_fired"] and info["n_iter_f32"] > 0
    np.testing.assert_allclose(float(post["x"]["v"]), float(jpost["x"]["v"]),
                               rtol=1e-10)
    whole, n_whole = solver.solve(model)
    np.testing.assert_allclose(float(post["x"]["v"]),
                               float(whole["x"]["v"]), rtol=1e-8)
