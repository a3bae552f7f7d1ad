"""The committees' EP, tramp_tpu_torch against tramp_tpu, float64 on the
CPU: the soft committee (K = 2 relu experts) and the sign committee (K = 3
sign experts and a sign output), N = 40, whose sum channel takes K inputs
and whose experts' linear channels sit in branches of a tree. Through
``EPSolver`` on both sides: equal n_iter and convergence flags, r and v at
rtol 1e-8 for every expert's x (and the sign committee's a); the soft
committee's x inside the JAX test's band. Then 3 lanes on one F, a y per
lane, against their single solves (rtol 1e-10, equal n_iter), through
``dispatch_solver``, which must pick ``EPSolver`` for a tree.
"""
import pytest
import torch

from tramp_tpu import parallel as jparallel

from tramp_tpu_torch import channels, models, parallel

from torch_parity import assert_close, committee_case

F64 = torch.float64


@pytest.mark.parametrize("kind", ["soft", "sgn"])
def test_committee_ep_matches_jax(kind):
    j_student, student, _ = committee_case(kind)
    K = 2 if kind == "soft" else 3
    ids = [f"x_{k}" for k in range(K)] + ["a"] * (kind == "sgn")
    assert any(type(f) is channels.SumChannel for f in student.factors)
    kw = dict(damping=0.3, max_iter=60, tol=1e-6)
    post, n_iter, conv = parallel.EPSolver(student, **kw).solve_info(student)
    j_post, j_n, j_conv = jparallel.EPSolver(j_student, **kw).solve_info(
        j_student)
    assert int(n_iter) == int(j_n) and bool(conv) == bool(j_conv)
    for id in ids:
        assert_close(post[id]["r"], j_post[id]["r"], 1e-8, what=id)
        assert_close(post[id]["v"], j_post[id]["v"], 1e-8, what=id)
    if kind == "soft":
        for id in ids:
            assert torch.isfinite(post[id]["r"]).all()
            assert 0 < float(post[id]["v"]) < 1.5


def test_committee_lanes_against_single_solves():
    """The soft committee built by the port, 3 lanes on the teacher's F, a
    teacher x and y per lane (with_buffers)."""
    g = torch.Generator().manual_seed(5)
    teacher = models.soft_committee(
        K=2, N=40, alpha=1.5, ensemble_type="gaussian",
        prior_mean=[0.1, -0.2], prior_var=[1.0, 1.0], noise_var=1e-2,
        generator=g, device="cpu", dtype=F64)
    student = teacher.to_observed({"y": teacher.sample(g)["y"]})
    ys = torch.stack([teacher.sample(g)["y"] for _ in range(3)])
    likelihood = len(student.factors) - 1
    stacked = parallel.with_buffers(student, {(likelihood, "y"): ys})
    solver = parallel.dispatch_solver(student, damping=0.3, max_iter=80)
    assert type(solver) is parallel.EPSolver
    post, n_iter = solver.solve_batch(stacked)
    for i in range(3):
        single = parallel.with_buffers(student, {(likelihood, "y"): ys[i]})
        s_post, s_n = solver.solve(single)
        assert int(n_iter[i]) == int(s_n)
        for id in ("x_0", "x_1", "a_0"):
            assert_close(post[id]["r"][i], s_post[id]["r"], 1e-10, what=id)
            assert_close(post[id]["v"][i], s_post[id]["v"], 1e-10, what=id)
