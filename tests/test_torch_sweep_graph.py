"""The loop of ``parallel.MLVAMPSolver`` as one in-place iteration, and its
replay as a captured CUDA graph (``parallel.loop``).

On the CPU (float64):

- the loop, its iteration now one function that updates the loop's state in
  place, gives the bits of the loop it replaced (``_loop_before``, written
  here as it was): ``n_iter``, ``conv``, the posteriors and the carry, for
  the relu net at one instance and at three lanes, the perceptron (a sign
  likelihood, which is not pinned), and a warm restart from
  ``solve_batch_with_state``, whose state the solve leaves as it was;
- the signature that decides a new capture follows every factor tensor's
  storage but the terminal factor's, and the numbers and switches the step
  reads (the eager loop on the CPU and on a mesh, and a moved tensor, are
  tests/test_torch_solver_loop.py's, for the generic loop too).

On the card (``-m cuda``; this file imports no JAX, so it runs there with
``--noconftest``), the relu net of N = 4096, M = 2048 in float64: the graph
against the eager loop, bit for bit with each lane's ``n_iter`` equal, at
one instance and at 64 lanes; a second call with fresh observations; a
factor that reads the device from the host, whose capture fails into the
eager loop; a tensor that moved, which is captured again; and the message
kernels' launch counters, one launch of each per replay.
"""
import pytest
import torch

import tramp_tpu_torch as tt
from tramp_tpu_torch import config, trace
from tramp_tpu_torch.channels import GaussianChannel, LinearChannel, ReluChannel
from tramp_tpu_torch.lanes import model_lanes, select
from tramp_tpu_torch.ops import pl_fused
from tramp_tpu_torch.parallel import MLVAMPSolver, loop, with_buffers
from tramp_tpu_torch.parallel.mesh import all_done
from tramp_tpu_torch.priors import GaussBernoulliPrior

from torch_stand_in_graph import stand_in_graphs  # noqa: F401

F64 = torch.float64


@pytest.fixture(autouse=True)
def fresh_spans_and_plans(monkeypatch):
    "Spans recorded from zero; no plan of another test."
    monkeypatch.setattr(config, "TRACE", True)
    monkeypatch.setattr(MLVAMPSolver, "_plans", {})
    trace.reset()
    yield
    trace.reset()


def _loop_before(solver, model, carry=None):
    """The loop of ``MLVAMPSolver._run`` as it was written before its
    iteration became ``_iterate``: (post, carry, n_iter, conv)."""
    B = model_lanes(model, solver.template)
    inv = solver._invariants(model, B)
    if carry is None:
        carry = solver._init(model, B)
    old_r = solver._metric(carry, inv)
    flags = () if B is None else (B,)
    n_iter = torch.zeros(flags, dtype=torch.int64)
    done = torch.zeros(flags, dtype=torch.bool)
    conv = torch.zeros(flags, dtype=torch.bool)

    def norm(x):
        x = x**2
        x = x.reshape(x.shape[0], -1) if B else x.reshape(-1)
        return torch.sqrt(x.mean(-1))

    def both(fn, new, old):
        return (tuple({k: fn(n[k], o[k]) for k in n}
                      for n, o in zip(new[0], old[0])),
                {k: fn(new[1][k], old[1][k]) for k in new[1]})

    for i in range(solver.max_iter):
        new_carry = solver._step(model, carry, inv)
        ok = torch.stack(
            [torch.isfinite(x.reshape(x.shape[0], -1) if B else
                            x.reshape(-1)).all(-1)
             for x in loop.leaves(new_carry)]).all(0)
        new_carry = both(lambda n, o: select(ok, n, o), new_carry, carry)
        new_r = solver._metric(new_carry, inv)
        delta = torch.stack([
            norm(n - o) / torch.clamp(norm(n), min=torch.finfo(n.dtype).tiny)
            for n, o in zip(new_r, old_r)]).amax(0)
        converged = (delta < solver.tol) if i > 0 else torch.zeros_like(done)
        active = ~done
        if B is not None:
            new_carry = both(lambda n, o: select(active, n, o), new_carry,
                             carry)
            new_r = tuple(select(active, n, o)
                          for n, o in zip(new_r, old_r))
        carry, old_r = new_carry, new_r
        n_iter = torch.where(active, i + 1, n_iter)
        conv = conv | (active & converged)
        done = done | converged | ~ok
        if all_done(done, []):
            break
    return solver._readout(model, carry, inv, B), carry, n_iter, conv


def _relu_net(N, M, lanes, device, seed=0, rho=0.25,
              prior=GaussBernoulliPrior):
    """(student, model): the relu net of N x M on ``device``, W of N(0,
    1/N) entries, the student observing the first of ``lanes``
    observations and the model all of them (None: one instance); the
    prior of the class ``prior``."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=F64, device=device)
    W = torch.randn(M, N, generator=g, **kw) / N**0.5
    n = lanes or 1
    x = ((torch.rand(n, N, generator=g, **kw) < rho)
         * torch.randn(n, N, generator=g, **kw))
    ys = (x @ W.T).clamp(min=0) + 0.1 * torch.randn(n, M, generator=g, **kw)
    teacher = (prior(size=N, rho=rho, **kw) @ tt.V(id="x")
               @ LinearChannel(W, name="W", **kw) @ tt.V(id="z")
               @ ReluChannel() @ tt.V(id="a")
               @ GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
    student = teacher.to_observed({"y": ys[0]})
    return student, (student if lanes is None
                     else with_buffers(student, {(3, "y"): ys}))


def _perceptron(lanes):
    """(student, model): the perceptron of N = 60 (binary prior, sign
    likelihood) on the CPU, one instance or ``lanes`` observations."""
    g = torch.Generator().manual_seed(3)
    teacher = tt.glm_generative(
        N=60, alpha=1.2, ensemble_type="gaussian", prior_type="binary",
        output_type="sgn", generator=g, device="cpu", dtype=F64,
        prior_p_pos=0.25)
    ys = torch.stack([teacher.sample(g)["y"] for _ in range(lanes or 1)])
    student = teacher.to_observed({"y": ys[0]})
    return student, (student if lanes is None
                     else with_buffers(student, {(2, "y"): ys}))


def _assert_same_bits(got, want):
    post, carry, n_iter, conv = got
    post_w, carry_w, n_iter_w, conv_w = want
    assert torch.equal(n_iter, n_iter_w)
    assert conv is None or torch.equal(conv, conv_w)
    assert post.keys() == post_w.keys()
    for vid in post:
        for k in ("r", "v"):
            assert torch.equal(post[vid][k], post_w[vid][k]), (vid, k)
    assert len(loop.leaves(carry)) == len(loop.leaves(carry_w))
    for a, b in zip(loop.leaves(carry), loop.leaves(carry_w)):
        assert torch.equal(a, b)


CASES = {
    "relu_one_instance": lambda: _relu_net(60, 40, None, "cpu"),
    "relu_three_lanes": lambda: _relu_net(60, 40, 3, "cpu"),
    "perceptron_one_instance": lambda: _perceptron(None),
    "perceptron_three_lanes": lambda: _perceptron(3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_eager_loop_keeps_the_bits_of_the_loop_it_replaced(case):
    student, model = CASES[case]()
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-8, max_iter=150)
    got = solver._run(model)
    assert int(got[2].max()) > 2
    _assert_same_bits(got, _loop_before(solver, model))
    assert "replay" not in trace.summary() and solver._plans == {}


def test_a_warm_restart_keeps_the_bits_and_leaves_its_state():
    student, model = _relu_net(60, 40, 3, "cpu")
    first = MLVAMPSolver(student, damping=0.1, tol=1e-8, max_iter=4)
    _, state, n_first = first.solve_batch_with_state(model)
    assert n_first.tolist() == [4, 4, 4]
    kept = [t.clone() for t in loop.leaves(state)]
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-8, max_iter=150)
    post, carry, n_iter = solver.solve_batch_with_state(model, state)
    want = _loop_before(solver, model, state)
    _assert_same_bits((post, carry, n_iter, None), want)
    for a, b in zip(loop.leaves(state), kept):
        assert torch.equal(a, b)


def _signature(solver, model):
    B = model_lanes(model, solver.template)
    return loop.signature(solver, model, solver._invariants(model, B), None,
                          B, solver.tol)


def test_the_signature_follows_what_a_graph_reads():
    student, model = _relu_net(60, 40, 3, "cpu")
    solver = MLVAMPSolver(student, damping=0.1)
    base = _signature(solver, model)
    # a fresh observation is copied in: no new capture
    fresh = with_buffers(model, {(3, "y"): model.factors[3].y.clone()})
    assert _signature(solver, fresh) == base
    # an operator with the same values in another storage
    W = with_buffers(model, {(1, "V"): model.factors[1].V.clone()})
    assert _signature(solver, W) != base
    # observations of another layout, a number the step reads, the tol
    assert _signature(solver, with_buffers(
        model, {(3, "y"): model.factors[3].y[:2]})) != base
    assert _signature(solver, with_buffers(model, {(0, "rho"): 0.3})) != base
    solver.tol = 1e-9
    assert _signature(solver, model) != base


@pytest.mark.parametrize("lanes", [None, 3])
def test_the_plan_s_buffers_keep_the_bits_on_the_cpu(lanes, stand_in_graphs):
    """The plan's path with a stand-in graph: the loop's bits; a second
    call's observations copied in, not captured again; the carry handed
    out a copy, not the plan's own."""
    student, model = _relu_net(60, 40, lanes, "cpu", seed=1)
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-8, max_iter=150)
    got = solver._run(model, own=True)
    _assert_same_bits(got, _loop_before(solver, model))
    # the first iteration is the capture's
    spans = trace.summary()
    assert spans["capture"]["count"] == 1
    assert spans["replay"]["count"] + 1 == spans["sweep"]["count"] \
        == int(got[2].max())
    _, other = _relu_net(60, 40, lanes, "cpu", seed=2)
    other = with_buffers(model, {(3, "y"): other.factors[3].y})
    trace.reset()
    again = solver._run(other, own=True)
    _assert_same_bits(again, _loop_before(solver, other))
    spans = trace.summary()
    assert "capture" not in spans
    assert spans["replay"]["count"] == int(again[2].max())
    own = loop.leaves(MLVAMPSolver._plans[lanes].loop["carry"])
    assert not {t.data_ptr() for t in loop.leaves(again[1])} & {
        t.data_ptr() for t in own}
    # n_iter and conv are not the plan's flags, which the next call zeroes
    n_iter = again[2].clone()
    solver._run(model)
    assert torch.equal(again[2], n_iter)


def test_the_plan_s_warm_restart_on_the_cpu(stand_in_graphs):
    """A warm restart keeps the bits on the plan; its carry's layouts
    enter the signature, so it captures a plan of its own."""
    student, model = _relu_net(60, 40, 3, "cpu", seed=1)
    _, state, _ = MLVAMPSolver(student, damping=0.1, tol=1e-8,
                               max_iter=4).solve_batch_with_state(model)
    assert trace.summary()["capture"]["count"] == 1
    kept = [t.clone() for t in loop.leaves(state)]
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-8, max_iter=150)
    post, carry, n_iter = solver.solve_batch_with_state(model, state)
    _assert_same_bits((post, carry, n_iter, None),
                      _loop_before(solver, model, state))
    assert trace.summary()["capture"]["count"] == 2
    for a, b in zip(loop.leaves(state), kept):
        assert torch.equal(a, b)


# -- on the card --------------------------------------------------------------

N, M = 4096, 2048


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False


def _solve(solver, model, eager=False):
    """``solver._run(model)`` synchronised; ``eager``: with the graph path
    shut, for the comparison."""
    with pytest.MonkeyPatch.context() as patch:
        if eager:
            patch.setattr(loop, "why_eager",
                          lambda model, device, groups: "eager")
        out = solver._run(model, own=True)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 64])
def test_the_graph_keeps_the_eager_bits_on_card(lanes):
    _card()
    student, model = _relu_net(N, M, lanes, "cuda", seed=5)
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6, max_iter=500)
    want = _solve(solver, model, eager=True)
    assert "replay" not in trace.summary()
    got = _solve(solver, model)
    _assert_same_bits(got, want)
    # the first iteration is the capture's
    spans = trace.summary()
    assert spans["capture"]["count"] == 1
    assert spans["replay"]["count"] + 1 == int(got[2].max()) > 2
    # a second call with fresh observations: copied in, not captured again
    _, again = _relu_net(N, M, lanes, "cuda", seed=6)
    again = with_buffers(model, {(3, "y"): again.factors[3].y})
    trace.reset()
    got = _solve(solver, again)
    _assert_same_bits(got, _solve(solver, again, eager=True))
    spans = trace.summary()
    assert "capture" not in spans
    assert spans["replay"]["count"] == int(got[2].max())


class _ReadingPrior(GaussBernoulliPrior):
    "A prior whose forward message reads the device from the host."

    def compute_forward_message(self, ax, bx):
        if bx.device.type == "cuda" and float(bx.abs().sum()) < 0:
            raise AssertionError("unreachable")
        return super().compute_forward_message(ax, bx)


@pytest.mark.cuda
def test_a_factor_that_reads_the_device_runs_eagerly_on_card():
    """The capture fails: that solve finishes eagerly, and the plan keeps
    its signature as failed, so later solves of it run eagerly."""
    _card()
    student, model = _relu_net(N, M, 8, "cuda", seed=7, prior=_ReadingPrior)
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6, max_iter=500)
    got = _solve(solver, model)
    plan = MLVAMPSolver._plans[8]
    assert plan.failed and plan.loop is None
    _assert_same_bits(got, _solve(solver, model, eager=True))
    _assert_same_bits(_solve(solver, model), got)
    spans = trace.summary()
    assert spans["capture"]["count"] == 1 and "replay" not in spans


@pytest.mark.cuda
def test_a_moved_tensor_is_captured_again_on_card():
    _card()
    student, model = _relu_net(N, M, 8, "cuda", seed=8)
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6, max_iter=500)
    _solve(solver, model)
    moved = with_buffers(model, {(1, "V"): model.factors[1].V.clone()})
    _assert_same_bits(_solve(solver, moved),
                      _solve(solver, moved, eager=True))
    assert trace.summary()["capture"]["count"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 64])
def test_a_replay_counts_one_launch_of_each_message_on_card(lanes):
    _card()
    student, model = _relu_net(N, M, lanes, "cuda", seed=9)
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6, max_iter=500)
    counters = (pl_fused.pl_forward_message, pl_fused.pl_backward_message,
                pl_fused.pl_posterior)
    # the capture's solve: its first iteration eager, then replays
    for _ in range(2):
        before = [f.launches for f in counters]
        trace.reset()
        _, _, n_iter, _ = _solve(solver, model)
        loops = trace.summary()["sweep"]["count"]
        assert loops == int(n_iter.max()) > 2
        assert [f.launches - n for f, n in zip(counters, before)] == [
            loops, loops, 0]
    assert trace.summary()["replay"]["count"] == loops
