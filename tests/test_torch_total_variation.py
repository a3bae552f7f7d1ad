"""The sparse-gradient and total-variation models, tramp_tpu_torch against
tramp_tpu, float64 on the CPU.

- One sweep of each of the four builders (sparse-gradient and TV,
  regression and classification; 1-D and 2-D images) from the JAX engine's
  state after 3 sweeps, exported and converted (torch_parity.describe_state,
  convert.state_from_numpy): every slot and the carried spectral image at
  rtol 1e-10. The TV models start from ConstantInit(a=1, b=1): the group
  threshold of the L21 prior needs a direction, and with lanes its group
  axis (0 of the gradient's (d,) + shape) moves one along
  (priors/map_priors.py).

Full solves are in tests/test_torch_total_variation_solves.py, the batched
solves in tests/test_torch_total_variation_batch.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import models as jmodels
from tramp_tpu.algos import ConstantInit as JConstantInit

import tramp_tpu_torch as tt
from tramp_tpu_torch import convert, models

from torch_parity import assert_states_close, describe_state, port_model

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


def _instance(x_shape, seed, classify=False):
    "(A, y, x0) of a piecewise-constant signal, numpy."
    rng = np.random.RandomState(seed)
    N = int(np.prod(x_shape))
    M = (3 * N) // 4
    x0 = np.cumsum(rng.randn(N) * (rng.rand(N) < 0.2))
    A = rng.randn(M, N) / np.sqrt(N)
    y = A @ x0 + 1e-2 * rng.randn(M)
    return A, (np.sign(y) if classify else y), x0


CASES = {
    "sparse_gradient_regression": ((16,), dict(grad_rho=0.2)),
    "sparse_gradient_classification": ((16,), dict(grad_rho=0.2)),
    "tv_regression": ((16,), dict(grad_scale=1.0)),
    "tv_classification": ((4, 5), dict(grad_scale=1.0)),
    "tv_regression_2d": ((4, 5), dict(grad_scale=1.0)),
}


def _jax_model(case, seed=0):
    x_shape, kw = CASES[case]
    name = case.replace("_2d", "")
    A, y, _ = _instance(x_shape, seed, classify="classification" in case)
    build = getattr(jmodels, name)
    return build(jnp.asarray(A), jnp.asarray(y), x_shape=x_shape,
                 noise_var=1e-2, prior_var=1.0, **kw), (A, y, x_shape, kw)


def _init(case, jax=True):
    if case.startswith("tv"):
        return (JConstantInit if jax else tt.ConstantInit)(a=1.0, b=1.0)
    return None


@pytest.mark.parametrize("case", list(CASES))
def test_one_sweep_from_a_jax_state(case):
    j_model, _ = _jax_model(case)
    model = port_model(j_model)
    j_eng = jt.ExpectationPropagation(j_model)
    eng = tt.ExpectationPropagation(model)
    damp = j_eng._damping_per_slot(0.1)
    state = j_eng.init_state(_init(case))
    for _ in range(3):
        state = j_eng._sweep(j_eng.model, state, damp)
    p_state = convert.state_from_numpy(
        *describe_state(state, j_eng.n_slots), **CPU)
    j_next = j_eng._sweep(j_eng.model, state, damp)
    p_next = eng._sweep(eng.model, p_state, eng._damping_per_slot(0.1))
    assert_states_close(p_next, j_next, j_eng.n_slots, 1e-10, what=case)


@pytest.mark.parametrize("case", list(CASES))
def test_port_builders_build_the_jax_model(case):
    "The port's builder gives the converted JAX model, factor by factor."
    j_model, (A, y, x_shape, kw) = _jax_model(case)
    name = case.replace("_2d", "")
    model = getattr(models, name)(A, y, x_shape=x_shape, noise_var=1e-2,
                                  prior_var=1.0, **kw, **CPU)
    ref = port_model(j_model)
    assert [type(n).__name__ for n in model.nodes] == \
        [type(n).__name__ for n in ref.nodes]
    assert model.edges == ref.edges
    assert model.get_shapes() == ref.get_shapes()
