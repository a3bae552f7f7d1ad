"""ML-VAMP's loop finish as one laned kernel
(tramp_tpu_torch/csrc/ml_vamp_finish.cu, ops/ml_vamp_finish.py) on the
card. Every test skips where there is no CUDA device; this file imports no
JAX, so it runs on the card with ``python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_ml_vamp_finish_kernel.py``.

- The kernel against the plain version (the solver's eager chain) on the
  same loop state: the carry, the metric, the flags it advances, ``ok`` and
  ``converged`` bit for bit, ``delta`` within 4 ulps (its sums are taken in
  another order). States: the relu net of N = 4096, M = 2048 at 64 lanes
  and as one instance, a 3-layer chain, a 6-layer chain (49 leaves), an
  unpinned terminal, in float32 and float64, with frozen lanes and with a lane whose step is made not
  finite, at the solver's tol and at one every lane meets.
- A state on the card that the kernel does not take raises, and runs
  nothing.
- A whole solve replayed as a graph through the kernel gives every lane the
  ``n_iter`` and the posteriors of the eager loop through the plain
  version, and counts one launch per loop iteration.
- Registers: ptxas reports no spill, for both types.
"""
import pytest
import torch

import tramp_tpu_torch as tt
from tramp_tpu_torch import config, trace
from tramp_tpu_torch.channels import GaussianChannel, LinearChannel, ReluChannel
from tramp_tpu_torch.ops import _build
from tramp_tpu_torch.ops import ml_vamp_finish as mvf
from tramp_tpu_torch.parallel import MLVAMPSolver, loop, ml_vamp, with_buffers
from tramp_tpu_torch.parallel.mesh import map_tree
from tramp_tpu_torch.priors import GaussBernoulliPrior

F32, F64 = torch.float32, torch.float64
ULPS = 4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False


def _chain(widths, lanes, dtype, seed=0):
    """(student, model) on the card: a prior of widths[0] elements, then per
    further width a LinearChannel to it and a ReluChannel, a Gaussian
    likelihood; the model with ``lanes`` observations (None: one)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(dtype=dtype, device="cuda")
    chain = GaussBernoulliPrior(size=widths[0], rho=0.25, **kw) @ tt.V(
        id="x")
    z = ((torch.rand(lanes or 1, widths[0], generator=g, **kw) < 0.25)
         * torch.randn(lanes or 1, widths[0], generator=g, **kw))
    for i, (n, m) in enumerate(zip(widths, widths[1:])):
        W = torch.randn(m, n, generator=g, **kw) / n**0.5
        chain = (chain @ LinearChannel(W, name=f"W{i}", **kw)
                 @ tt.V(id=f"z{i}") @ ReluChannel() @ tt.V(id=f"a{i}"))
        z = (z @ W.T).clamp(min=0)
    ys = z + 0.1 * torch.randn(z.shape, generator=g, **kw)
    teacher = (chain @ GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
    student = teacher.to_observed({"y": ys[0]})
    index = len(student.factors) - 1
    return student, (student if lanes is None
                     else with_buffers(student, {(index, "y"): ys}))


def _bits(t):
    "A tensor's bits, so that NaNs compare too."
    return t.view({F64: torch.int64, F32: torch.int32}.get(t.dtype, t.dtype))


CASES = {
    "relu_64": dict(widths=(4096, 2048), lanes=64, dtype=F64),
    "relu_64_f32": dict(widths=(4096, 2048), lanes=64, dtype=F32),
    "relu_one": dict(widths=(4096, 2048), lanes=None, dtype=F64),
    "relu_one_f32": dict(widths=(4096, 2048), lanes=None, dtype=F32),
    "three_layers": dict(widths=(1024, 768, 512), lanes=16, dtype=F64),
    "three_layers_f32": dict(widths=(1024, 768, 512), lanes=16, dtype=F32),
    "six_layers": dict(widths=(1024, 768, 512, 384, 256, 192), lanes=16,
                       dtype=F64),
    "six_layers_f32": dict(widths=(1024, 768, 512, 384, 256, 192),
                           lanes=16, dtype=F32),
    "unpinned": dict(widths=(1024, 512), lanes=16, dtype=F64,
                     pin_terminal=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["none", "frozen", "not_finite"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_kernel_keeps_the_plain_bits_on_card(case, fault):
    _card()
    spec = dict(CASES[case])
    pin = spec.pop("pin_terminal", True)
    student, model = _chain(**spec)
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6, max_iter=500,
                          pin_terminal=pin)
    B, _, inv, _ = solver._prepare(model, None)
    state = solver._start(model, inv, B, None)
    for _ in range(3):
        solver._iterate(model, inv, B, state, solver.tol)
    new = solver._step(model, state["carry"], inv)
    if fault == "frozen" and B is not None:
        state["flags"]["done"][::3] = True
    elif fault == "not_finite":
        leaf = new[0][0]["fb"]
        (leaf[5] if B is not None else leaf)[17] = float("nan")
    old = state["carry"]
    for tol in (solver.tol, 1e3):
        outs = []
        for fn in (mvf.ml_vamp_finish, mvf.ml_vamp_finish_plain):
            carry, metric, flags = map_tree(
                torch.clone, (old, state["metric"], state["flags"]))
            pairs = [(c if n is o else n, c) for (n, o), (c, _) in zip(
                solver._pairs(new, old), solver._pairs(carry, old))]
            args = (pairs, solver._sides(carry, inv), metric, flags, B)
            assert mvf.takes(*args)
            before = mvf.ml_vamp_finish.launches
            out = fn(*args, tol)
            torch.cuda.synchronize()
            assert mvf.ml_vamp_finish.launches - before == (
                fn is mvf.ml_vamp_finish)
            outs.append(((carry, metric, flags), out))
        (state_k, (ok, conv, delta)), (state_w, (ok_w, conv_w, delta_w)) = (
            outs)
        for g, w in zip(loop.leaves(state_k), loop.leaves(state_w)):
            assert g.shape == w.shape and torch.equal(_bits(g), _bits(w))
        for g, w in ((ok, ok_w), (conv, conv_w)):
            assert g.shape == w.shape and torch.equal(g, w), (case, tol)
        assert delta.shape == delta_w.shape
        eps = torch.finfo(delta.dtype).eps
        assert torch.equal(delta.isnan(), delta_w.isnan())
        finite = ~delta_w.isnan()
        assert bool(((delta - delta_w).abs()[finite]
                     <= ULPS * eps * delta_w.abs()[finite]).all()), case
        if fault == "not_finite":
            assert not bool(ok.reshape(-1)[5 if B is not None else 0])
        if tol == 1e3:
            # a lane that is not kept keeps its metric: its change is 0
            assert bool(conv.all())


@pytest.mark.cuda
def test_a_state_the_kernel_does_not_take_raises_on_card():
    _card()
    student, model = _chain((1024, 512), 16, F64)
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6)
    B, _, inv, _ = solver._prepare(model, None)
    state = solver._start(model, inv, B, None)
    new = solver._step(model, state["carry"], inv)
    pairs = list(solver._pairs(new, state["carry"]))
    n, o = pairs[1]
    kept = o.clone()
    pairs[1] = (n, o.t().contiguous().t())
    args = (pairs, solver._sides(state["carry"], inv), state["metric"],
            state["flags"], B)
    assert not mvf.takes(*args)
    before = mvf.ml_vamp_finish.launches
    with pytest.raises(ValueError, match="not contiguous"):
        mvf.ml_vamp_finish(*args, solver.tol)
    with pytest.raises(ValueError, match="float32 or float64"):
        mvf.ml_vamp_finish(*map_tree(
            lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
            args[:3]), state["flags"], B, solver.tol)
    torch.cuda.synchronize()
    assert mvf.ml_vamp_finish.launches == before
    assert torch.equal(o, kept) and int(state["flags"]["count"]) == 0


def _solve(solver, model, kernel):
    """``solver._run(model)`` synchronised: through the kernel, its
    iteration replayed as a graph, or eagerly through the plain version;
    with the kernel's launches and the loop's iterations."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(MLVAMPSolver, "_plans", {})
        if not kernel:
            patch.setattr(loop, "why_eager",
                          lambda model, device, groups: "eager")
            patch.setattr(ml_vamp, "ml_vamp_finish",
                          mvf.ml_vamp_finish_plain)
        trace.reset()
        before = mvf.ml_vamp_finish.launches
        out = solver._run(model, own=True)
        torch.cuda.synchronize()
        spans = trace.summary()
        return (out, mvf.ml_vamp_finish.launches - before,
                spans["sweep"]["count"], spans.get("replay", {}))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 64])
def test_a_replayed_solve_keeps_each_lane_s_n_iter_on_card(lanes,
                                                          monkeypatch):
    _card()
    monkeypatch.setattr(config, "TRACE", True)
    student, model = _chain((4096, 2048), lanes, F64, seed=5)
    solver = MLVAMPSolver(student, damping=0.1, tol=1e-6, max_iter=500)
    want, launches_w, _, replay_w = _solve(solver, model, kernel=False)
    assert launches_w == 0 and not replay_w
    got, launches, loops, replay = _solve(solver, model, kernel=True)
    (post, carry, n_iter, conv), (post_w, carry_w, n_iter_w, conv_w) = (
        got, want)
    assert torch.equal(n_iter, n_iter_w) and torch.equal(conv, conv_w)
    assert replay["count"] + 1 == loops == int(n_iter.max()) > 2
    assert launches == loops
    for vid in post:
        for k in ("r", "v"):
            assert torch.equal(post[vid][k], post_w[vid][k]), (vid, k)
    for g, w in zip(loop.leaves(carry), loop.leaves(carry_w)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_ptxas_spills_nothing_on_card():
    _card()
    _, log = mvf.build()
    rows = [row for row in _build.ptxas_report(log)
            if row["kernel"] == "ml_vamp_finish_kernel"]
    assert sorted(row["dtype"] for row in rows) == ["d", "f"], log
    assert all(row["spill_bytes"] == 0 for row in rows), rows
