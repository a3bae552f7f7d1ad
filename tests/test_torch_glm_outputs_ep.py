"""The EP side of the GLMs the remaining factors open, tramp_tpu_torch
against tramp_tpu, float64 on the CPU: the perceptron (binary prior, sign
output; bench.py:504-533) at N = 200 through ``EPSolver`` and
``dispatch_solver`` (an ``MLVAMPSolver``) against JAX;
``channel2likelihood`` picking the JAX package's class for every channel
it converts (``ModulusChannel`` too, since ROADMAP Queue 1 item 4a);
``glm_generative`` building and observing a perceptron. The state
evolution of the same GLMs is in tests/test_torch_glm_outputs.py.

Tolerances (torch_parity.assert_close): the perceptron's posterior means
and variances at rtol 1e-8 (roundoff compounded over the damped sweeps),
with equal n_iter and convergence flags.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import channels as jchannels
from tramp_tpu import parallel as jparallel
from tramp_tpu.likelihoods import SgnLikelihood as JSgnLikelihood
from tramp_tpu.models.dag_algebra import (
    channel2likelihood as jchannel2likelihood)
from tramp_tpu.priors import BinaryPrior as JBinaryPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch import channels, parallel
from tramp_tpu_torch.models.dag_algebra import channel2likelihood

from torch_parity import assert_close, port_model

F64 = torch.float64


def _perceptron(N=200, alpha=1.0, p_pos=0.25, seed=21):
    """(JAX student, port student, teacher x): the perceptron of
    bench.py:504-533 at a smaller N, data from numpy."""
    M = int(alpha * N)
    rng = np.random.RandomState(seed)
    W = rng.randn(M, N) / np.sqrt(N)
    x0 = np.where(rng.rand(N) < p_pos, 1.0, -1.0)
    y = np.sign(W @ x0)
    y[y == 0] = 1.0
    student = (JBinaryPrior(size=N, p_pos=p_pos) @ jt.V(id="x")
               @ jchannels.LinearChannel(jnp.asarray(W), name="W")
               @ jt.V(id="z") @ JSgnLikelihood(y=jnp.asarray(y))).to_model()
    return student, port_model(student), x0


@pytest.mark.parametrize("solver", ["EPSolver", "dispatch_solver"])
def test_perceptron_ep_matches_jax(solver):
    j_student, student, x0 = _perceptron()
    kw = dict(damping=0.1, max_iter=300, tol=1e-6)
    if solver == "EPSolver":
        mine, ref = (parallel.EPSolver(student, **kw),
                     jparallel.EPSolver(j_student, **kw))
    else:
        mine, ref = (parallel.dispatch_solver(student, **kw),
                     jparallel.dispatch_solver(j_student, **kw))
        assert type(mine) is parallel.MLVAMPSolver
        assert type(ref).__name__ == "MLVAMPSolver"
    post, n_iter, conv = mine.solve_info(student)
    j_post, j_n_iter, j_conv = ref.solve_info(j_student)
    assert int(n_iter) == int(j_n_iter) and bool(conv) == bool(j_conv)
    assert bool(conv)
    for id in ("x", "z"):
        assert_close(post[id]["r"], j_post[id]["r"], 1e-8, what=id)
        assert_close(post[id]["v"], j_post[id]["v"], 1e-8, what=id)
    mse = float(np.mean((post["x"]["r"].numpy() - x0) ** 2))
    assert mse < 0.5 and 0 < float(post["x"]["v"]) < 1


CHANNEL_CASES = {
    "gaussian": dict(var=0.3), "abs": {}, "a-abs": dict(shift=1e-3),
    "sgn": {}, "relu": {}, "l-relu": dict(slope=0.2), "h-tanh": {},
    "h-sigm": {}, "door": dict(width=0.4),
}


@pytest.mark.parametrize("kind", list(CHANNEL_CASES))
def test_channel2likelihood_picks_the_jax_class(kind):
    kw = CHANNEL_CASES[kind]
    y = np.abs(np.random.RandomState(0).randn(6))
    got = channel2likelihood(channels.get_channel(kind, **kw),
                             y=torch.as_tensor(y), y_name="y")
    want = jchannel2likelihood(jchannels.get_channel(kind, **kw),
                               y=jnp.asarray(y), y_name="y")
    assert type(got).__name__ == type(want).__name__
    for field in type(want)._meta_fields:
        assert getattr(got, field) == getattr(want, field), field
    if hasattr(want, "var"):
        assert got.var == want.var
    assert got.y.dtype == F64 and np.array_equal(got.y.numpy(), y)


def test_modulus_channel_and_complex_glm_wait_for_item_4():
    """Item 4a is in: the ModulusChannel branch converts as the JAX
    package's does, and the complex GLM builds (its EP against JAX is in
    tests/test_torch_phase_retrieval.py)."""
    y = torch.ones(3, dtype=F64)
    got = channel2likelihood(channels.ModulusChannel(), y=y, y_name="y")
    want = jchannel2likelihood(jchannels.ModulusChannel(), y=jnp.ones(3),
                               y_name="y")
    assert type(got).__name__ == type(want).__name__ == "ModulusLikelihood"
    assert got.y is y and got.y_name == "y"
    model = tt.glm_generative(N=20, alpha=0.5, ensemble_type="gaussian",
                              prior_type="gauss_bernoulli",
                              output_type="modulus", device="cpu", dtype=F64,
                              generator=torch.Generator().manual_seed(0))
    assert type(model.factors[1]) is channels.ComplexLinearChannel
    assert model.get_shapes()["x"] == (2, 20)


def test_glm_generative_builds_the_perceptron_and_observes_it():
    g = torch.Generator().manual_seed(3)
    teacher = tt.glm_generative(
        N=60, alpha=1.0, ensemble_type="gaussian", prior_type="binary",
        output_type="sgn", generator=g, device="cpu", dtype=F64,
        prior_p_pos=0.25)
    sample = teacher.sample(g)
    assert set(sample["x"].unique().tolist()) <= {-1.0, 1.0}
    student = teacher.to_observed({"y": sample["y"]})
    assert type(student.factors[-1]).__name__ == "SgnLikelihood"
    post, n_iter = parallel.dispatch_solver(
        student, damping=0.1, max_iter=200).solve(student)
    assert post["x"]["r"].shape == (60,) and int(n_iter) > 1
    assert bool(torch.isfinite(post["x"]["r"]).all())
