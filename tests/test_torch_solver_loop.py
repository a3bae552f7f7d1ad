"""The solver loop of ``parallel.loop`` that ``SpectralVAMPSolver``,
``MLVAMPSolver`` and the generic loop (``EPSolver``, ``SESolver``) share.

On the CPU (float64):

- ``SpectralVAMPSolver``'s loop, its iteration now one function that
  updates the loop's state in place, gives the bits of the loop it replaced
  (``_loop_before``, written here as it was): the posteriors, ``n_iter`` and
  ``conv``, at one instance and at three lanes, with k below and at Nz,
  damped, and with lanes that stop at ``max_iter``; it keeps no plan, even
  where a graph could run;
- for ML-VAMP and the generic loop alike: a model on the CPU or on a mesh
  runs eagerly, with no plan and no ``replay`` or ``capture`` span; a
  tensor that moved is captured again where the plan reads it where it lies
  (ML-VAMP's operator) and copied in where the plan copies it (the generic
  loop's), with the eager loop's bits either way.

The cases of ML-VAMP and of the generic loop are those of
tests/test_torch_sweep_graph.py and tests/test_torch_generic_loop_graph.py.
"""
import types

import pytest
import torch

import tramp_tpu_torch as tt
from tramp_tpu_torch import config, trace
from tramp_tpu_torch.channels import GaussianChannel, LinearChannel
from tramp_tpu_torch.lanes import (
    last_axis, lane_values, model_lanes, per_lane, select,
)
from tramp_tpu_torch.parallel import (
    EPSolver, MLVAMPSolver, SESolver, SpectralVAMPSolver, loop, with_buffers,
)
from tramp_tpu_torch.parallel.mesh import all_done
from tramp_tpu_torch.priors import GaussBernoulliPrior

from test_torch_generic_loop_graph import _tree as ep_tree
from test_torch_sweep_graph import _relu_net as relu_net
from torch_stand_in_graph import stand_in_graphs  # noqa: F401

F64 = torch.float64


@pytest.fixture(autouse=True)
def fresh_spans_and_plans(monkeypatch):
    "Spans recorded from zero; no plan of another test."
    monkeypatch.setattr(config, "TRACE", True)
    for cls in (MLVAMPSolver, EPSolver, SESolver):
        monkeypatch.setattr(cls, "_plans", {})
    trace.reset()
    yield
    trace.reset()


# -- SpectralVAMPSolver ------------------------------------------------------

def _loop_before(solver, model):
    """The loop of ``SpectralVAMPSolver._run`` as it was written before its
    iteration became ``_iterate``: (post, n_iter, conv)."""
    B = model_lanes(model, solver.template)
    spectral = solver._spectral(model)
    prior, lin, p, s2d = spectral
    carry = solver._init(model, spectral)
    flags = () if B is None else (B,)
    old_v = torch.full(flags, float("inf"), dtype=p.dtype)
    n_iter = torch.zeros(flags, dtype=torch.int64)
    done = torch.zeros(flags, dtype=torch.bool)
    conv = torch.zeros(flags, dtype=torch.bool)
    for i in range(solver.max_iter):
        new_carry, (_, v1) = solver._step(model, carry, spectral)
        ok = (torch.isfinite(per_lane(new_carry[0], B)).all(-1)
              & torch.isfinite(new_carry[1]).reshape(flags))
        new_carry = tuple(select(ok, n, o) for n, o in zip(new_carry, carry))
        v1 = v1.reshape(flags)
        converged = (torch.abs(v1 - old_v) < solver.tol) if i > 0 \
            else torch.zeros_like(done)
        active = ~done
        if B is not None:
            new_carry = tuple(select(active, n, o)
                              for n, o in zip(new_carry, carry))
            v1 = torch.where(active, v1, old_v)
        carry, old_v = new_carry, v1
        n_iter = torch.where(active, i + 1, n_iter)
        conv = conv | (active & converged)
        done = done | converged | ~ok
        if all_done(done, []):
            break
    r1, gamma1 = carry
    x1, v1, r2, gamma2 = solver._lmmse_input(prior, r1, gamma1)
    lanes = B is not None
    t = lin._mm(lin.V, r2, transpose=True, lanes=lanes)
    den = s2d + gamma2
    d = (gamma2 * t + p) / den
    z_hat = lin._mm(lin.U, lin.s * d, lanes=lanes)
    v_z = last_axis(lin.s**2 / den, torch.sum) / lin.Nx
    post = {solver.x_id: {"r": x1, "v": lane_values(v1, B)},
            solver.z_id: {"r": z_hat, "v": lane_values(v_z, B)}}
    return post, n_iter, conv


def _glm(M, N, lanes, seed=0, rho=0.3, noise=1e-2):
    """(student, model): the compressed-sensing GLM of M x N on the CPU, the
    student observing the first of ``lanes`` observations and the model all
    of them (None: one instance)."""
    g = torch.Generator().manual_seed(seed)
    W = torch.randn(M, N, generator=g, dtype=F64) / N**0.5
    n = lanes or 1
    x = ((torch.rand(n, N, generator=g, dtype=F64) < rho)
         * torch.randn(n, N, generator=g, dtype=F64))
    ys = x @ W.T + noise**0.5 * torch.randn(n, M, generator=g, dtype=F64)
    teacher = (GaussBernoulliPrior(size=N, rho=rho, dtype=F64) @ tt.V(id="x")
               @ LinearChannel(W, name="W", dtype=F64) @ tt.V(id="z")
               @ GaussianChannel(var=noise) @ tt.O(id="y")).to_model()
    student = teacher.to_observed({"y": ys[0]})
    return student, (student if lanes is None
                     else with_buffers(student, {(2, "y"): ys}))


#: (M, N, lanes, rho, solver keywords): k at Nz (M >= N: LinearChannel's
#: Nz is the size of x) and below it, lanes that converge at different
#: iterations, damped, and a lane that reaches max_iter beside lanes that
#: converge
VAMP_CASES = {
    "one_instance_k_eq_nz": (120, 80, None, 0.3, {}),
    "one_instance_k_lt_nz": (70, 90, None, 0.2, {}),
    "three_lanes_k_eq_nz": (120, 80, 3, 0.3, {}),
    "three_lanes_k_lt_nz": (70, 90, 3, 0.2, {}),
    "three_lanes_k_lt_nz_damped": (60, 90, 3, 0.3, {"damping": 0.3}),
    "three_lanes_max_iter": (60, 90, 3, 0.2, {"tol": 1e-8,
                                               "max_iter": 100}),
}


@pytest.mark.parametrize("case", sorted(VAMP_CASES))
def test_the_vamp_loop_keeps_the_bits_of_the_loop_it_replaced(case):
    M, N, lanes, rho, kw = VAMP_CASES[case]
    student, model = _glm(M, N, lanes, rho=rho)
    solver = SpectralVAMPSolver(student, **dict(dict(tol=1e-9), **kw))
    post, _, n_iter, conv = solver._run(model)
    want, n_want, conv_want = _loop_before(solver, model)
    assert int(n_iter.min()) > 2
    assert torch.equal(n_iter, n_want) and torch.equal(conv, conv_want)
    assert post.keys() == want.keys()
    for vid in post:
        for k in ("r", "v"):
            assert torch.equal(post[vid][k], want[vid][k]), (vid, k)
    if lanes:
        assert n_iter.shape == (lanes,) and len(set(n_iter.tolist())) > 1 \
            or case == "three_lanes_k_eq_nz"
    if case == "three_lanes_max_iter":
        assert n_iter.tolist()[2] == 100 and conv.tolist() == [
            True, True, False]
    spans = trace.summary()
    assert spans["sweep"]["count"] == int(n_iter.max())
    assert spans["solve"]["count"] == spans["readout"]["count"] == 1


def test_the_vamp_loop_keeps_no_plan(stand_in_graphs):
    "Where a graph could replay the loop, SpectralVAMP's runs eagerly."
    student, model = _glm(120, 80, 3)
    solver = SpectralVAMPSolver(student, tol=1e-9)
    _, n_iter = solver.solve_batch(model)
    assert torch.equal(n_iter, _loop_before(solver, model)[1])
    spans = trace.summary()
    assert "capture" not in spans and "replay" not in spans
    assert SpectralVAMPSolver._plans is None


# -- ML-VAMP and the generic loop --------------------------------------------

def _relu_net():
    """(solver, model, carry) of an ML-VAMP solve of the relu net of 60 x 40
    on the CPU at three lanes, from the zero carry."""
    student, model = relu_net(60, 40, 3, "cpu")
    return MLVAMPSolver(student, damping=0.1, tol=1e-8, max_iter=150), \
        model, None


def _ep_tree():
    "(solver, model, state) of an EP solve of a tree at three lanes."
    return ep_tree(50, 40, 3, "cpu")


SOLVERS = {"ml_vamp": _relu_net, "ep_tree": _ep_tree}


def _bits(out):
    "The answers of a ``_run``: the posteriors, n_iter and conv."
    post, _, n_iter, conv = out
    return [n_iter, conv] + [post[v][k] for v in sorted(post)
                             for k in sorted(post[v])]


def _assert_same_bits(got, want):
    for a, b in zip(_bits(got), _bits(want), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_a_model_on_the_cpu_runs_eagerly(solver):
    solver, model, carry = SOLVERS[solver]()
    assert loop.why_eager(model, torch.device("cpu"), []) == \
        "the loop is not on a CUDA device"
    solver._run(model, carry)
    solver._run(model, carry)
    spans = trace.summary()
    assert spans["sweep"]["count"] > 4
    assert "replay" not in spans and "capture" not in spans
    assert type(solver)._plans == {}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_a_model_on_a_mesh_runs_eagerly(solver):
    _, model, _ = SOLVERS[solver]()
    on_mesh = "the model is on a mesh"
    cuda = torch.device("cuda")
    # a stop flag reduced over process groups
    assert loop.why_eager(model, cuda, [object()]) == on_mesh
    # lanes or operators split over the mesh (``shard_batched_model``)
    split = with_buffers(model, {})
    split.mesh_lanes = types.SimpleNamespace()
    assert loop.why_eager(split, cuda, []) == on_mesh
    assert loop.why_eager(with_buffers(split, {}), cuda, []) == on_mesh


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_a_moved_tensor_keeps_the_bits_on_the_cpu(solver, stand_in_graphs,
                                                  monkeypatch):
    """An operator moved to another storage with the same values: ML-VAMP
    reads it where it lies, so its plan is captured again; the generic loop
    copies it in, so its plan replays. The bits are the eager loop's."""
    solver, model, carry = SOLVERS[solver]()
    first = solver._run(model, carry)
    moved = with_buffers(model, {(1, "V"): model.factors[1].V.clone()})
    trace.reset()
    got = solver._run(moved, carry)
    recaptured = isinstance(solver, MLVAMPSolver)
    assert trace.summary().get("capture", {}).get("count", 0) == recaptured
    assert list(type(solver)._plans) == [3]
    _assert_same_bits(got, first)
    monkeypatch.setattr(loop, "why_eager", lambda *args: "eager")
    _assert_same_bits(got, solver._run(moved, carry))
