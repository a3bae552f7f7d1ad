"""Phase retrieval's EP half, tramp_tpu_torch against tramp_tpu, float64 on
the CPU: the complex GLM (Gauss-Bernoulli prior over packed (2, N) x,
``ComplexLinearChannel``, ``ModulusLikelihood``) of BASELINE config 2's
second half (bench.py:573-618) at N = 64, through ``EPSolver`` and
``dispatch_solver`` (an ``MLVAMPSolver``: the chain is SISO and the complex
operator is a generic factor on both sides) with bench.py's stop rule
(``stop_kind="v"``, tol 1e-12, wait_increase 20): equal n_iter and
convergence flags, r at rtol 1e-8 (roundoff compounded over some 400
damped sweeps) and v, at the AMIN floor of deep recovery, at rtol 1e-6; 3
lanes that share F, one y each, against their single solves (r at rtol
1e-10, v at 1e-6, equal n_iter); and ``glm_generative`` with
``output_type="modulus"`` building, sampling and observing the complex GLM.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu import parallel as jparallel
from tramp_tpu.channels import ComplexLinearChannel as JComplexLinear
from tramp_tpu.likelihoods import ModulusLikelihood as JModulusLikelihood
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import tramp_tpu_torch as tt
from tramp_tpu_torch import channels, likelihoods, parallel
from tramp_tpu_torch.algos.metrics import phase_symmetric_mse

from torch_parity import assert_close, port_model

F64 = torch.float64
N, ALPHA, RHO, MEAN = 64, 2.0, 0.5, 0.01
SOLVE = dict(damping=0.3, max_iter=500, tol=1e-12, wait_increase=20,
             stop_kind="v")


def _instance(seed):
    "bench.py's instance at N = 64: (F, teacher x packed, y)."
    M = int(ALPHA * N)
    rng = np.random.RandomState(seed)
    F = (rng.randn(M, N) + 1j * rng.randn(M, N)) / np.sqrt(2 * N)
    mask = rng.rand(N) < RHO
    x0 = mask[None, :] * (MEAN + rng.randn(2, N) * np.sqrt(0.5))
    return F, x0, np.abs(F @ (x0[0] + 1j * x0[1]))


def _student(seed=5):
    F, x0, y = _instance(seed)
    j_student = (
        JGaussBernoulliPrior(size=(2, N), rho=RHO, mean=MEAN)
        @ jt.V(id="x") @ JComplexLinear(F, name="F") @ jt.V(id="z")
        @ JModulusLikelihood(y=jnp.asarray(y))).to_model()
    return j_student, port_model(j_student), x0


@pytest.mark.parametrize("solver", ["EPSolver", "dispatch_solver"])
def test_complex_glm_matches_jax(solver):
    j_student, student, x0 = _student()
    assert type(student.factors[1]) is channels.ComplexLinearChannel
    assert student.factors[1].U.dtype == torch.complex128
    if solver == "EPSolver":
        mine = parallel.EPSolver(student, **SOLVE)
        ref = jparallel.EPSolver(j_student, **SOLVE)
    else:
        kw = dict(damping=0.3, max_iter=500, tol=1e-6)
        mine = parallel.dispatch_solver(student, **kw)
        ref = jparallel.dispatch_solver(j_student, **kw)
        assert type(mine) is parallel.MLVAMPSolver
        assert type(ref).__name__ == "MLVAMPSolver"
    post, n_iter, conv = mine.solve_info(student)
    j_post, j_n_iter, j_conv = ref.solve_info(j_student)
    assert int(n_iter) == int(j_n_iter) and bool(conv) == bool(j_conv)
    assert bool(conv)
    for id in ("x", "z"):
        assert post[id]["r"].shape == np.shape(j_post[id]["r"])
        assert_close(post[id]["r"], j_post[id]["r"], 1e-8, what=id)
        # v sits at the AMIN floor (about 5e-12: a sum of precisions near
        # the AMAX clip), where the two packages' last sweeps differ in
        # the clip's rounding
        assert_close(post[id]["v"], j_post[id]["v"], 1e-6, what=id)
    mse = float(phase_symmetric_mse(torch.as_tensor(x0), post["x"]["r"]))
    assert mse < 1e-2 * RHO


def test_complex_glm_lanes_against_single_solves():
    "3 lanes on one F, a y per lane (with_buffers), against single solves."
    _, student, _ = _student()
    F = student.factors[1].W
    ys = []
    for seed in (11, 12, 13):
        rng = np.random.RandomState(seed)
        mask = rng.rand(N) < RHO
        x = mask[None, :] * (MEAN + rng.randn(2, N) * np.sqrt(0.5))
        ys.append(torch.abs(F @ torch.complex(*torch.as_tensor(x))))
    stacked = parallel.with_buffers(student, {(2, "y"): torch.stack(ys)})
    solver = parallel.EPSolver(student, **SOLVE)
    post, n_iter = solver.solve_batch(stacked)
    assert post["x"]["r"].shape == (3, 2, N) and n_iter.shape == (3,)
    assert post["x"]["v"].shape == (3,)
    for i, y in enumerate(ys):
        single = parallel.with_buffers(student, {(2, "y"): y})
        s_post, s_n = solver.solve(single)
        assert int(n_iter[i]) == int(s_n)
        for id in ("x", "z"):
            assert_close(post[id]["r"][i], s_post[id]["r"], 1e-10,
                         what=f"{id} lane {i}")
            # v at the AMIN floor: a GEMM and a GEMV round differently
            assert_close(post[id]["v"][i], s_post[id]["v"], 1e-6,
                         what=f"{id} lane {i}")


def test_glm_generative_builds_the_complex_glm():
    g = torch.Generator().manual_seed(4)
    teacher = tt.glm_generative(
        N=N, alpha=ALPHA, ensemble_type="complex_gaussian",
        prior_type="gauss_bernoulli", output_type="modulus", generator=g,
        device="cpu", dtype=F64, prior_rho=RHO, prior_mean=MEAN)
    assert [type(f) for f in teacher.factors[1:]] == [
        channels.ComplexLinearChannel, channels.ModulusChannel]
    assert teacher.get_shapes() == {"x": (2, N), "z": (2, int(ALPHA * N)),
                                    "y": (int(ALPHA * N),)}
    sample = teacher.sample(g)
    W = teacher.factors[1].W
    z = W @ torch.complex(sample["x"][0], sample["x"][1])
    assert torch.allclose(sample["y"], torch.abs(z))
    student = teacher.to_observed({"y": sample["y"]})
    assert type(student.factors[-1]) is likelihoods.ModulusLikelihood
    post, n_iter, conv = parallel.EPSolver(student, **SOLVE).solve_info(
        student)
    assert bool(conv) and torch.isfinite(post["x"]["r"]).all()
    assert float(phase_symmetric_mse(sample["x"], post["x"]["r"])) < 1e-2


@pytest.mark.parametrize("kind", ["complex_gaussian", "unitary",
                                  "complex_unitary"])
def test_complex_ensembles(kind):
    from tramp_tpu_torch.ensembles import get_ensemble
    g = torch.Generator().manual_seed(0)
    kw = dict(N=8) if kind == "unitary" else dict(M=6, N=8)
    X = get_ensemble(kind, **kw).generate(g, device="cpu", dtype=F64)
    assert X.dtype == torch.complex128
    if kind == "unitary":
        assert torch.allclose(X @ X.conj().T, torch.eye(8, dtype=X.dtype))
        channels.UnitaryChannel(X)
    elif kind == "complex_unitary":
        assert torch.allclose(X.abs(), torch.ones_like(X.real))
    else:
        # real and imaginary parts N(0, 1/N): E|X_ij|^2 = 2/N
        big = get_ensemble(kind, M=400, N=100).generate(g, device="cpu")
        assert abs(float((big.abs() ** 2).mean()) * 100 / 2 - 1) < 0.05
