"""The generic loop of ``parallel.EPSolver`` and ``parallel.SESolver`` as one
in-place iteration, and its replay as a captured CUDA graph
(``parallel.loop``).

On the CPU (float64):

- the loop, its iteration now one function that updates the loop's state in
  place, gives the bits of the loop it replaced (``_loop_before``, written
  here as it was): the posteriors, ``n_iter`` and ``conv``, over a 12-point
  SE grid of the compressed-sensing GLM that holds points which converge,
  one that reaches ``max_iter`` next to the critical line and one that
  rolls back, started from the initial state and from the state a first
  solve ended in, and over an EP tree (one instance and three lanes);
- the plan's buffers, run with a stand-in graph whose replay runs the
  iteration, keep those bits, are captured once for a new solver of the
  same structure, hand a warm restart's state and the bf16-gated mode's
  answers out untouched by a later solve, and add the quadrature's node
  count of the eager loop;
- the signature follows tol, ``config.STATE_BF16``, the lane count and a
  number of a factor, and not fresh values of the tensors copied in;
- an iteration of the SE grid and of the EP tree copies nothing from the
  host and reads nothing of the device (what no capture can hold);
- (the eager loop on the CPU and on a mesh, and a moved tensor, are
  tests/test_torch_solver_loop.py's, for ML-VAMP too).

On the card (``-m cuda``; this file imports no JAX, so it runs there with
``--noconftest``): the graph against the eager loop, bit for bit, on a
103-point grid and on the EP tree; two grids of one structure built one
after the other capture once and a grid of another lane count captures its
own plan; a prior that reads the device from the host falls back to the
eager loop; a replay adds the eager loop's node count.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import tramp_tpu_torch as tt
from tramp_tpu_torch import config, trace
from tramp_tpu_torch.channels import GaussianChannel, LinearChannel
from tramp_tpu_torch.lanes import select, stack_models, with_buffers
from tramp_tpu_torch.parallel import (
    EPSolver, SESolver, build_se_grid, loop, solve_se_grid,
)
from tramp_tpu_torch.parallel.mesh import all_done
from tramp_tpu_torch.priors import GaussBernoulliPrior
from tramp_tpu_torch.utils import integration

from torch_stand_in_graph import stand_in_graphs  # noqa: F401

F64 = torch.float64


@pytest.fixture(autouse=True)
def fresh_spans_and_plans(monkeypatch):
    "Spans recorded from zero; no plan of another test."
    monkeypatch.setattr(config, "TRACE", True)
    monkeypatch.setattr(SESolver, "_plans", {})
    monkeypatch.setattr(EPSolver, "_plans", {})
    trace.reset()
    yield
    trace.reset()


def _loop_before(solver, model, state, tol=None):
    """The loop of ``_Solver._run`` as it was written before its iteration
    became ``_iterate``: (post, state, n_iter, conv)."""
    eng, kind = solver.engine, solver.stop_kind
    tol = solver.tol if tol is None else tol
    B = eng._lanes(state)
    aux = eng._prepare(model)
    if eng.spectral_factors:
        state = eng._refresh_spectral_cache(state, model)
    old_m = eng._metric(state, kind)
    device = state[0]["a"].device
    flags = () if B is None else (B,)
    n_iter = torch.zeros(flags, dtype=torch.int64, device=device)
    done = torch.zeros(flags, dtype=torch.bool, device=device)
    conv = torch.zeros(flags, dtype=torch.bool, device=device)

    def keep(flag, kept, other):
        return tuple({k: select(flag, a[k], b[k]) for k in a}
                     for a, b in zip(kept, other))

    for i in range(solver.max_iter):
        swept = eng._sweep(model, state, solver.damp, aux)
        ok = eng._all_finite(swept)
        swept = keep(ok, swept, state)
        new_m = eng._metric(swept, kind)
        delta, inc = eng._delta_increase(kind, new_m, old_m, lanes=B)
        converged = (delta < tol) if i > 0 else torch.zeros_like(done)
        rb = (inc > solver.rollback_increase) \
            if i > solver.wait_increase else torch.zeros_like(done)
        swept = keep(rb, state, swept)
        active = ~done
        if B is not None:
            swept = keep(active, swept, state)
            new_m = [select(active, n, o) for n, o in zip(new_m, old_m)]
        state, old_m = swept, new_m
        n_iter = torch.where(active, i + 1, n_iter)
        conv = conv | (active & converged)
        done = done | converged | rb | ~ok
        if all_done(done, []):
            break
    post = {eng.nodes[vi].id: solver._post(vi, state, B)
            for vi in eng.variable_indices}
    return post, state, n_iter, conv


def _assert_same_bits(got, want):
    post, state, n_iter, conv = got
    post_w, state_w, n_iter_w, conv_w = want
    assert torch.equal(n_iter, n_iter_w)
    assert torch.equal(conv, conv_w)
    assert post.keys() == post_w.keys()
    for vid in post:
        assert post[vid].keys() == post_w[vid].keys()
        for k in post[vid]:
            assert torch.equal(post[vid][k], post_w[vid][k]), (vid, k)
    assert len(state) == len(state_w)
    for m, m_w in zip(state, state_w):
        assert m.keys() == m_w.keys()
        for k in m:
            assert torch.equal(m[k], m_w[k])


# -- the cases ---------------------------------------------------------------

#: (alpha, rho, prior variance, a0) of the 12 points: points that converge,
#: one next to the critical line that reaches max_iter (alpha 0.42, rho
#: 0.25) and one started far from its fixed point whose mean variance grows
#: past the rollback bound after the wait (alpha 0.2, rho 0.25, a0 100)
SE_POINTS = [(0.1, 0.25, 1.0, 0.0), (0.3, 0.25, 1.0, 0.0),
             (0.42, 0.25, 1.0, 0.0), (0.6, 0.25, 1.0, 0.0),
             (0.9, 0.25, 1.0, 0.0), (1.5, 0.25, 1.0, 0.0),
             (0.5, 0.05, 1.0, 0.0), (0.8, 0.5, 1.0, 0.0),
             (1.2, 0.75, 1.0, 0.0), (2.0, 0.95, 1.0, 0.0),
             (0.2, 0.25, 4.0, 100.0), (0.7, 0.15, 1.0, 0.0)]
SE_MAX_ITER = 80


def _se_point(alpha, rho, var):
    return tt.glm_state_evolution(
        alpha=alpha, prior_type="gauss_bernoulli", output_type="gaussian",
        prior_rho=rho, prior_mean=0.0, prior_var=var, output_var=1e-11)


def _se_grid(device="cpu", points=SE_POINTS, max_iter=SE_MAX_ITER):
    """(solver, model, initial state) of the SE grid of ``points``: the
    points' models stacked into lanes, an initializer per point."""
    models = [_se_point(a, r, v) for a, r, v, _ in points]
    solver = SESolver(models[0], tol=1e-6, max_iter=max_iter, device=device,
                      dtype=F64)
    stacked = stack_models(models, device=device, dtype=F64)
    inits = [tt.CustomInit(a_init=[("x", "bwd", a0)])
             for *_, a0 in points]
    states = [solver._with_lanes(solver.init_state(iz), 1) for iz in inits]
    state = tuple({"a": torch.cat([st[s]["a"] for st in states])}
                  for s in range(len(states[0])))
    return solver, stacked, state


def _tree(N, M, lanes, device, seed=0, dtype=F64, **solver_kw):
    """(solver, model, initial state) of an EP tree: x ~ Gauss-Bernoulli
    observed through two operators, each with its Gaussian noise (a SIMO
    variable, so no chain); one instance, or ``lanes`` observations of
    each."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=dtype, device=device)
    Ws = [torch.randn(M, N, generator=g, **kw) / N**0.5 for _ in range(2)]
    teacher = (GaussBernoulliPrior(size=N, rho=0.3, **kw)
               @ tt.SIMOVariable(id="x", n_next=2)
               @ (LinearChannel(Ws[0], name="W0", **kw)
                  + LinearChannel(Ws[1], name="W1", **kw))
               @ (tt.V(id="z_0") + tt.V(id="z_1"))
               @ (GaussianChannel(var=1e-2) + GaussianChannel(var=2e-2))
               @ (tt.O(id="y_0") + tt.O(id="y_1"))).to_model()
    x = ((torch.rand(lanes or 1, N, generator=g, **kw) < 0.3)
         * torch.randn(lanes or 1, N, generator=g, **kw))
    ys = [x @ W.T + s * torch.randn(lanes or 1, M, generator=g, **kw)
          for W, s in zip(Ws, (0.1, 2e-2**0.5))]
    student = teacher.to_observed({"y_0": ys[0][0], "y_1": ys[1][0]})
    solver = EPSolver(student, **dict(dict(damping=0.2, tol=1e-8,
                                           max_iter=200), **solver_kw))
    if lanes is None:
        return solver, student, solver.init_state()
    lik = [i for i, f in enumerate(student.factors) if f.n_next == 0]
    model = with_buffers(student, {(lik[0], "y"): ys[0],
                                   (lik[1], "y"): ys[1]})
    return solver, model, solver._with_lanes(solver.init_state(), lanes)


def _se_restart():
    """The SE grid from the state a first solve ended in: its converged
    points' first sweep moves them by less than tol, which stops no lane
    before its second sweep."""
    solver, model, state = _se_grid()
    return solver, model, _loop_before(solver, model, state)[1]


CASES = {
    "se_grid12": lambda: _se_grid(),
    "se_grid12_restart": _se_restart,
    "ep_tree_one_instance": lambda: _tree(50, 40, None, "cpu"),
    "ep_tree_three_lanes": lambda: _tree(50, 40, 3, "cpu"),
}


def test_the_se_grid_holds_its_three_kinds_of_points():
    solver, model, state = _se_grid()
    _, _, n_iter, conv = solver._run(model, state)
    kinds = ["conv" if c else "max_iter" if n == SE_MAX_ITER else "rollback"
             for n, c in zip(n_iter.tolist(), conv.tolist())]
    assert kinds[2] == "max_iter" and kinds[10] == "rollback"
    assert kinds.count("conv") == 10


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_eager_loop_keeps_the_bits_of_the_loop_it_replaced(case):
    solver, model, state = CASES[case]()
    got = solver._run(model, state)
    assert int(got[2].max()) > 2
    _assert_same_bits(got, _loop_before(solver, model, state))
    spans = trace.summary()
    assert "replay" not in spans and "capture" not in spans
    assert type(solver)._plans == {}


def test_the_eager_loop_leaves_the_initial_state():
    solver, model, state = _se_grid()
    kept = [m["a"].clone() for m in state]
    solver._run(model, state)
    for m, a in zip(state, kept):
        assert torch.equal(m["a"], a)


# -- the signature ---------------------------------------------------------

def _signature(solver, model, state, tol=None):
    eng = solver.engine
    aux = eng._fill_aux(model, state, eng._prepare(model))
    return loop.signature(solver, model, aux, state, eng._lanes(state),
                          solver.tol if tol is None else tol)


def test_the_signature_follows_what_a_graph_reads(monkeypatch):
    solver, model, state = _se_grid()
    base = _signature(solver, model, state)
    # a new solver of the same structure, other values of the tensors
    # copied in: the same graph
    moved = [(a + 0.01, min(r + 0.01, 0.99), v, a0)
             for a, r, v, a0 in SE_POINTS]
    other, other_model, other_state = _se_grid(points=moved)
    assert _signature(other, other_model, other_state) == base
    # tol (the gated mode's two phases run with two)
    assert _signature(solver, model, state, tol=1e-5) != base
    # the state's storage in bfloat16 (a switch the sweep reads)
    monkeypatch.setattr(config, "STATE_BF16", True)
    assert _signature(solver, model, state) != base
    monkeypatch.setattr(config, "STATE_BF16", None)
    assert _signature(solver, model, state) == base
    # the lane count
    few, few_model, few_state = _se_grid(points=SE_POINTS[:5])
    assert _signature(few, few_model, few_state) != base
    # a number of a factor, baked into the graph's kernels
    noisier = [_se_point(a, r, v) for a, r, v, _ in SE_POINTS]
    for m in noisier:
        m.factors[-1].var = 1e-10
    noisier = stack_models(noisier, device="cpu", dtype=F64)
    assert _signature(solver, noisier, state) != base


# -- the plan's path on the CPU ----------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plan_s_buffers_keep_the_bits_on_the_cpu(case, stand_in_graphs):
    solver, model, state = CASES[case]()
    want = _loop_before(solver, model, state)
    got = solver._run(model, state, own=True)
    _assert_same_bits(got, want)
    # the first iteration is the capture's
    spans = trace.summary()
    assert spans["capture"]["count"] == 1
    assert spans["replay"]["count"] + 1 == spans["sweep"]["count"] \
        == int(got[2].max())
    # the answers are not the plan's buffers, which the next solve writes
    plan = type(solver)._plans[solver.engine._lanes(state)]
    own = {t.data_ptr() for t in loop.leaves(plan.loop)}
    assert not {t.data_ptr() for t in loop.leaves(got)} & own
    # a second solve replays the plan: no capture
    trace.reset()
    _assert_same_bits(solver._run(model, state), want)
    assert "capture" not in trace.summary()


def test_a_new_grid_of_one_structure_replays_the_plan_on_the_cpu(
        stand_in_graphs):
    """``build_se_grid`` makes a new solver for every grid: the plans on
    the class capture once, and each grid keeps its eager bits."""
    def grid(shift):
        return build_se_grid(
            tt.glm_state_evolution, {"alpha": np.linspace(0.3, 1.5, 4)
                                     + shift,
                                     "prior_rho": np.array([0.2, 0.6])},
            a0=0.0, max_iter=60, device="cpu", dtype=F64,
            prior_type="gauss_bernoulli", output_type="gaussian",
            prior_mean=0.0, prior_var=1.0, output_var=1e-11)

    for shift in (0.0, 0.013, -0.02):
        g = grid(shift)
        state = g.solver._with_lanes(g.solver.init_state(g.initializer), 8)
        want = _loop_before(g.solver, g.stacked, state)
        post, n_iter = solve_se_grid(g)
        assert torch.equal(n_iter, want[2])
        assert torch.equal(post["x"]["v"], want[0]["x"]["v"])
    assert trace.summary()["capture"]["count"] == 1
    assert list(SESolver._plans) == [8]


def test_a_warm_restart_s_state_outlives_a_later_solve_on_the_cpu(
        stand_in_graphs):
    short, model, _ = _tree(50, 40, 3, "cpu", seed=1, max_iter=4)
    _, state, n_first = short.solve_batch_with_state(model)
    assert n_first.tolist() == [4, 4, 4]
    kept = [t.clone() for t in loop.leaves(state)]
    # a later solve of another model of as many lanes, on the same plan
    solver, other, _ = _tree(50, 40, 3, "cpu", seed=2)
    solver.solve_batch(other)
    assert "capture" in trace.summary() and list(EPSolver._plans) == [3]
    for t, k in zip(loop.leaves(state), kept):
        assert torch.equal(t, k)
    # the warm restart from it keeps the bits of the loop it replaced
    want = _loop_before(solver, model, state)
    _assert_same_bits(solver._run(model, state, own=True), want)
    for t, k in zip(loop.leaves(state), kept):
        assert torch.equal(t, k)


def test_the_gated_mode_keeps_its_bits_and_answers_on_the_cpu(
        monkeypatch, stand_in_graphs):
    f32 = torch.float32
    solver, model, _ = _tree(50, 40, 3, "cpu", seed=3, dtype=f32, tol=1e-5)
    _, other, _ = _tree(50, 40, 3, "cpu", seed=4, dtype=f32)
    got = solver.solve_batch_gated_bf16(model)
    kept = [t.clone() for t in loop.leaves(got)]
    # its two phases: two signatures, one plan of 3 lanes replacing the
    # other
    assert trace.summary()["capture"]["count"] == 2
    # the same call with the graph path shut
    monkeypatch.setattr(loop, "why_eager",
                        lambda model, device, groups: "eager")
    want = solver.solve_batch_gated_bf16(model)
    assert int(got[1].max()) > 2
    for a, b in zip(loop.leaves(got), loop.leaves(want)):
        assert torch.equal(a, b)
    # a later solve leaves the answers handed out
    monkeypatch.setattr(loop, "why_eager",
                        lambda model, device, groups: None)
    solver.solve_batch_gated_bf16(other)
    for t, k in zip(loop.leaves(got), kept):
        assert torch.equal(t, k)


def test_a_plan_counts_the_quadrature_nodes_of_the_eager_loop(
        monkeypatch, stand_in_graphs):
    solver, model, state = _se_grid()
    before = integration.nodes_evaluated
    on_plan = solver._run(model, state)
    counted = integration.nodes_evaluated - before
    monkeypatch.setattr(loop, "why_eager",
                        lambda model, device, groups: "eager")
    before = integration.nodes_evaluated
    eager = solver._run(model, state)
    assert integration.nodes_evaluated - before == counted > 0
    assert torch.equal(on_plan[2], eager[2])
    # lanes x the prior's 2 x 640 nodes a sweep, over the loop's sweeps
    assert counted == len(SE_POINTS) * 2 * 640 * int(eager[2].max())


class _HostData(TorchDispatchMode):
    "Records the operations no capture can hold: host data, device reads."

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in ("lift_fresh", "_local_scalar_dense",
                                           "is_nonzero"):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", sorted(CASES))
def test_an_iteration_copies_nothing_from_the_host(case, monkeypatch):
    monkeypatch.setattr(config, "PIN_CONSTANT_MESSAGES",
                        case.startswith("ep"))
    solver, model, state = CASES[case]()
    eng = solver.engine
    B = eng._lanes(state)
    aux = eng._fill_aux(model, state, eng._prepare(model))
    state = solver._start(model, aux, B, state)
    # the first iteration moves the quadrature's nodes to the device, once
    solver._iterate(model, aux, B, state, solver.tol)
    with _HostData() as seen:
        solver._iterate(model, aux, B, state, solver.tol)
    assert seen.seen == []


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False


def _solve(solver, model, state, eager=False):
    """``solver._run(model, state)`` synchronised; ``eager``: with the graph
    path shut, for the comparison."""
    with pytest.MonkeyPatch.context() as patch:
        if eager:
            patch.setattr(loop, "why_eager",
                          lambda model, device, groups: "eager")
        out = solver._run(model, state, own=True)
    torch.cuda.synchronize()
    return out


def _grid103(device, shift=0.0, rhos=(0.25,), prior=None):
    """(solver, model, state) of 103 alphas of the benchmark's axis; the
    prior of the class ``prior`` (None: the Gauss-Bernoulli prior)."""
    def point(**kw):
        model = tt.glm_state_evolution(**kw)
        if prior is not None:
            model.factors[0].__class__ = prior
        return model

    alphas = np.sort(np.concatenate([np.linspace(0.02, 2.0, 100) + shift,
                                     [0.0204, 0.408, 0.816]]))
    g = build_se_grid(
        point, {"alpha": alphas,
                                 "prior_rho": np.array(rhos)},
        a0=0.0, max_iter=200, device=device, dtype=F64,
        prior_type="gauss_bernoulli", output_type="gaussian",
        prior_mean=0.0, prior_var=1.0, output_var=1e-11)
    B = len(g.combos)
    return g.solver, g.stacked, g.solver._with_lanes(
        g.solver.init_state(g.initializer), B)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grid103", "ep_tree"])
def test_the_graph_keeps_the_eager_bits_on_card(case):
    _card()
    make = {"grid103": lambda: _grid103("cuda"),
            "ep_tree": lambda: _tree(2000, 1500, 16, "cuda", seed=5)}[case]
    solver, model, state = make()
    eager_solver, _, _ = make()
    want = _solve(eager_solver, model, state, eager=True)
    assert "replay" not in trace.summary()
    got = _solve(solver, model, state)
    _assert_same_bits(got, want)
    spans = trace.summary()
    assert spans["capture"]["count"] == 1
    assert spans["replay"]["count"] + 1 == int(got[2].max()) > 2
    # again, replayed from the first iteration
    trace.reset()
    _assert_same_bits(_solve(solver, model, state), want)
    spans = trace.summary()
    assert "capture" not in spans
    assert spans["replay"]["count"] == spans["sweep"]["count"]


@pytest.mark.cuda
def test_grids_of_one_structure_capture_once_on_card():
    _card()
    for shift in (0.0, 0.004):
        solver, model, state = _grid103("cuda", shift)
        got = _solve(solver, model, state)
        eager, _, _ = _grid103("cuda", shift)
        _assert_same_bits(got, _solve(eager, model, state, eager=True))
    assert trace.summary()["capture"]["count"] == 1
    # another lane count captures its own plan
    solver, model, state = _grid103("cuda", rhos=(0.25, 0.5))
    _solve(solver, model, state)
    assert trace.summary()["capture"]["count"] == 2
    assert sorted(SESolver._plans) == [103, 206]


class _ReadingPrior(GaussBernoulliPrior):
    "A prior whose SE forward message reads the device from the host."

    def compute_forward_state_evolution(self, ax):
        if float(ax.sum()) < 0:
            raise AssertionError("unreachable")
        return super().compute_forward_state_evolution(ax)


@pytest.mark.cuda
def test_a_prior_that_reads_the_device_runs_eagerly_on_card():
    _card()
    solver, model, state = _grid103("cuda", prior=_ReadingPrior)
    eager, _, _ = _grid103("cuda", prior=_ReadingPrior)
    want = _solve(eager, model, state, eager=True)
    got = _solve(solver, model, state)
    _assert_same_bits(got, want)
    assert SESolver._plans[103].failed
    _assert_same_bits(_solve(solver, model, state), want)
    spans = trace.summary()
    assert spans["capture"]["count"] == 1 and "replay" not in spans


@pytest.mark.cuda
def test_a_replay_adds_the_eager_node_count_on_card():
    _card()
    solver, model, state = _grid103("cuda")
    counts = []
    for _ in range(2):
        before = integration.nodes_evaluated
        _, _, n_iter, _ = _solve(solver, model, state)
        counts.append(integration.nodes_evaluated - before)
    eager, _, _ = _grid103("cuda")
    before = integration.nodes_evaluated
    _solve(eager, model, state, eager=True)
    assert counts == [integration.nodes_evaluated - before] * 2
    assert counts[0] == 103 * 2 * 640 * int(n_iter.max())
    assert trace.summary()["replay"]["count"] == 2 * int(n_iter.max()) - 1
