"""ML-VAMP's loop finish and its route to the laned kernel
(tramp_tpu_torch/ops/ml_vamp_finish.py), on the CPU.

- The wrapper runs the plain version off the card, bit for bit, and counts
  no launch: CPU tensors with lanes and without, and the meta tensors of a
  shape sweep.
- ``fits`` holds for the loop states the kernel is for (the relu net with
  lanes and without, in float32 and float64, a 3-layer chain, a 4-layer
  chain past the smaller table, an unpinned terminal, the GLM tail whose
  forward slot the loop leaves out), and for every state a solve hands the
  finish, eager and on the plan's buffers, a warm restart from a strided
  carry among them; it refuses, with the reason, past the larger table, a
  carry leaf that is not contiguous or shares its storage, and flags of
  another shape; ``takes`` refuses every CPU tensor.
- The wrapper's counter is in the solver loop's ``COUNTERS``, and ptxas's
  report reads the kernel's symbol.
The kernel against the plain version is
tests/test_torch_ml_vamp_finish_kernel.py, on the card; the plain version
against the loop it came from is tests/test_torch_sweep_graph.py.
"""
import pytest
import torch

import tramp_tpu_torch as tt
from tramp_tpu_torch.channels import GaussianChannel, LinearChannel, ReluChannel
from tramp_tpu_torch.ops import _build
from tramp_tpu_torch.ops import ml_vamp_finish as mvf
from tramp_tpu_torch.parallel import (
    MLVAMPSolver, loop, ml_vamp, with_buffers,
)
from tramp_tpu_torch.parallel.mesh import map_tree
from tramp_tpu_torch.priors import GaussBernoulliPrior

from torch_stand_in_graph import stand_in_graphs  # noqa: F401

F32, F64 = torch.float32, torch.float64


def _chain(widths, lanes, dtype=F64, seed=0, glm=False):
    """(student, model): a prior of widths[0] elements, then per further
    width a LinearChannel to it and a ReluChannel (none with ``glm``), a
    Gaussian likelihood; the model with ``lanes`` observations (None: one
    instance)."""
    g = torch.Generator().manual_seed(seed)
    kw = dict(dtype=dtype, device="cpu")
    chain = GaussBernoulliPrior(size=widths[0], rho=0.3, **kw) @ tt.V(id="x")
    z = ((torch.rand(lanes or 1, widths[0], generator=g, **kw) < 0.3)
         * torch.randn(lanes or 1, widths[0], generator=g, **kw))
    for i, (n, m) in enumerate(zip(widths, widths[1:])):
        W = torch.randn(m, n, generator=g, **kw) / n**0.5
        chain = chain @ LinearChannel(W, name=f"W{i}", **kw) @ tt.V(
            id=f"z{i}")
        z = z @ W.T
        if not glm:
            chain = chain @ ReluChannel() @ tt.V(id=f"a{i}")
            z = z.clamp(min=0)
    ys = z + 0.1 * torch.randn(z.shape, generator=g, **kw)
    teacher = (chain @ GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
    student = teacher.to_observed({"y": ys[0]})
    index = len(student.factors) - 1
    return student, (student if lanes is None
                     else with_buffers(student, {(index, "y"): ys}))


def _state(solver, model, iters=2):
    """The loop's state after ``iters`` iterations, the step's output from
    it, the invariants and B."""
    B, _, inv, _ = solver._prepare(model, None)
    state = solver._start(model, inv, B, None)
    for _ in range(iters):
        solver._iterate(model, inv, B, state, solver.tol)
    return state, solver._step(model, state["carry"], inv), inv, B


def _args(solver, state, new, inv, B, carry=None, metric=None, flags=None):
    """The finish's arguments from the loop state; ``carry``, ``metric``,
    ``flags``: copies to finish on instead of the state's own."""
    old = state["carry"]
    carry = old if carry is None else carry
    pairs = [(c if n is o else n, c) for (n, o), (c, _) in zip(
        solver._pairs(new, old), solver._pairs(carry, old))]
    return (pairs, solver._sides(carry, inv),
            state["metric"] if metric is None else metric,
            state["flags"] if flags is None else flags, B)


CASES = {
    "relu_lanes": dict(widths=(60, 40), lanes=3),
    "relu_one": dict(widths=(60, 40), lanes=None),
    "relu_lanes_f32": dict(widths=(60, 40), lanes=3, dtype=F32),
    "three_layers": dict(widths=(60, 40, 30), lanes=3),
    "glm_tail": dict(widths=(60, 40), lanes=3, glm=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_wrapper_runs_the_plain_version_off_the_card(case):
    student, model = _chain(**CASES[case])
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6)
    state, new, inv, B = _state(solver, model)
    if B is not None:
        state["flags"]["done"][1] = True     # a frozen lane
    outs = []
    for fn in (mvf.ml_vamp_finish, mvf.ml_vamp_finish_plain):
        carry, metric, flags = map_tree(
            torch.clone, (state["carry"], state["metric"], state["flags"]))
        before = mvf.ml_vamp_finish.launches
        out = fn(*_args(solver, state, new, inv, B, carry, metric, flags),
                 solver.tol)
        assert mvf.ml_vamp_finish.launches == before
        outs.append((loop.leaves(carry), metric, loop.leaves(flags), out))
    for got, want in zip(*outs):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)
    # the frozen lane kept its carry
    if B is not None:
        for kept, was in zip(outs[0][0], loop.leaves(state["carry"])):
            assert torch.equal(kept[1], was[1])


@pytest.mark.parametrize("lanes", [None, 3])
def test_meta_tensors_take_the_plain_shapes(lanes):
    student, model = _chain((60, 40), lanes)
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6)
    state, new, inv, B = _state(solver, model, iters=0)
    meta = map_tree(lambda t: t.to("meta"), (state, new, inv))
    before = mvf.ml_vamp_finish.launches
    got = mvf.ml_vamp_finish(*_args(solver, *meta, B), solver.tol)
    want = mvf.ml_vamp_finish_plain(*_args(solver, state, new, inv, B),
                                    solver.tol)
    assert mvf.ml_vamp_finish.launches == before
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(g.device.type == "meta" for g in got)


FITS = dict(CASES, unpinned=dict(widths=(60, 40), lanes=3))


@pytest.mark.parametrize("case", sorted(FITS))
def test_the_kernel_s_states_fit_and_the_cpu_is_refused(case):
    student, model = _chain(**FITS[case])
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6,
                          pin_terminal=case != "unpinned")
    state, new, inv, B = _state(solver, model)
    args = _args(solver, state, new, inv, B)
    pairs, sides, metric, flags, lanes = args
    assert mvf.fits(pairs, sides, metric, flags, lanes)
    assert not mvf.takes(*args)
    # the table: every carry leaf, and the pinned message where the metric
    # reads one (not the GLM tail's, whose interface it leaves out)
    leaves, slots = mvf._table(pairs, sides, metric, flags, lanes)
    pinned = 2 if case not in ("unpinned", "glm_tail") else 0
    assert len(leaves) == len(pairs) + pinned
    assert len(slots) == len(sides) == len(metric)
    skipped = sum(n is o for n, o in pairs)
    assert skipped == (2 if case == "glm_tail" else 0)


def test_the_table_s_cap_refuses_a_deeper_chain():
    """A 4-layer relu chain (40 leaves) is past the smaller table's 32 and
    fits the larger one; past its MAX_LEAVES leaves or MAX_SIDES
    interfaces the table is refused, with the reason."""
    student, model = _chain((30, 28, 26, 24, 22), 3)
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6)
    state, new, inv, B = _state(solver, model, iters=1)
    pairs, sides, metric, flags, lanes = _args(solver, state, new, inv, B)
    assert len(pairs) + 2 > 32
    assert mvf.fits(pairs, sides, metric, flags, lanes)
    more = pairs + [(torch.zeros(3, 1, dtype=F64), torch.zeros(3, 1,
                                                                dtype=F64))
                    for _ in range(mvf.MAX_LEAVES)]
    assert not mvf.fits(more, sides, metric, flags, lanes)
    with pytest.raises(ValueError, match="leaves, past the table"):
        mvf._table(more, sides, metric, flags, lanes)
    k = mvf.MAX_SIDES // len(sides) + 1
    with pytest.raises(ValueError, match="interfaces"):
        mvf._table(pairs, sides * k, [r.clone() for r in metric * k], flags,
                   lanes)


SOLVES = dict(CASES, unpinned=dict(widths=(60, 40), lanes=3),
              four_layers=dict(widths=(30, 28, 26, 24, 22), lanes=3),
              warm_strided=dict(widths=(60, 40), lanes=3))


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "plan"])
@pytest.mark.parametrize("case", sorted(SOLVES))
def test_every_state_a_solve_finishes_fits_the_kernel(case, graph,
                                                      monkeypatch, request):
    """On the card a state the kernel does not take raises: every call of
    the finish in a solve, eager or on a plan's buffers, fits."""
    if graph:
        request.getfixturevalue("stand_in_graphs")
    monkeypatch.setattr(MLVAMPSolver, "_plans", {})
    fitted = []

    def finish(pairs, sides, metric, flags, lanes, tol):
        fitted.append(mvf.fits(pairs, sides, metric, flags, lanes))
        return mvf.ml_vamp_finish(pairs, sides, metric, flags, lanes, tol)

    monkeypatch.setattr(ml_vamp, "ml_vamp_finish", finish)
    student, model = _chain(**SOLVES[case])
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6, max_iter=20,
                          pin_terminal=case != "unpinned")
    carry = None
    if case == "warm_strided":
        # a carry handed in with the lanes as its last stride
        _, carry, _, _ = solver._run(model, own=True)
        carry = map_tree(lambda t: t.t().contiguous().t() if t.ndim == 2
                         else t, carry)
        assert not all(t.is_contiguous() for t in loop.leaves(carry))
        fitted.clear()
    solver._run(model, carry, own=True)
    assert fitted and all(fitted)


@pytest.mark.parametrize("fault", ["strided_carry", "shared_storage",
                                   "flags_shape", "next_shape"])
def test_layouts_the_kernel_does_not_take(fault):
    student, model = _chain((60, 40), 3)
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6)
    state, new, inv, B = _state(solver, model)
    pairs, sides, metric, flags, lanes = _args(solver, state, new, inv, B)
    assert mvf.fits(pairs, sides, metric, flags, lanes)
    n, o = pairs[1]
    if fault == "strided_carry":
        pairs[1] = (n, torch.empty_strided(o.shape, (1, o.shape[0]),
                                           dtype=o.dtype))
    elif fault == "shared_storage":
        pairs[1] = (o, o.clone())
        pairs[2] = (pairs[2][0], pairs[1][1].view(-1)[:pairs[2][1].numel()]
                    .view(pairs[2][1].shape))
    elif fault == "flags_shape":
        flags = dict(flags, done=flags["done"][:2])
    else:
        pairs[1] = (n[:, :5], o)
    assert not mvf.fits(pairs, sides, metric, flags, lanes)


def test_the_counter_is_in_the_loop_s_counters():
    assert (mvf.ml_vamp_finish, "launches") in loop.COUNTERS


def test_ptxas_report_reads_the_finish_kernel():
    """The kernel's symbol as nvcc 12.8 mangles it: the anonymous
    namespace's hash ends in digits, which the name's length follows."""
    log = (
        "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__522fa74"
        "3_17_ml_vamp_finish_cu_50980d8221ml_vamp_finish_kernelIdEEvNS_6Fin"
        "ishE' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 60 registers, used 1 barriers, 256 bytes smem\n")
    assert _build.ptxas_report(log) == [
        {"kernel": "ml_vamp_finish_kernel", "dtype": "d", "params": [],
         "registers": 60, "spill_bytes": 0}]
