"""The port's spans (``tramp_tpu_torch.trace``) on the CPU.

- When spans record: never by default, nor with ``config.TRACE`` False under
  a profiler; with None under a profiler, on the host's clock and with no
  range in the profile; with True, as ranges in the profile too.
- What a solve records, for ``EPSolver``, ``SpectralVAMPSolver`` and
  ``MLVAMPSolver``, one instance and a batch: one ``solve`` and one
  ``readout``, a ``sweep`` and a ``stop_read`` per loop iteration, all of
  the run's solve and with ``solve`` as parent; self seconds within seconds.
- The answers with spans recording are bit-equal to those without, and a
  solve with nothing recording reads no clock and allocates nothing in the
  module.
- The store keeps its bound; the set-up spans ``svd`` and
  ``kernels.build`` (with ``kernels.compile`` per library built and
  ``kernels.load``).

This file imports no JAX.
"""
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tramp_tpu_torch as tt
from tramp_tpu_torch import config, trace
from tramp_tpu_torch.channels import (
    GaussianChannel, LinearChannel, ReluChannel,
)
from tramp_tpu_torch.ops import pl_fused
from tramp_tpu_torch.parallel import (
    EPSolver, MLVAMPSolver, SpectralVAMPSolver, with_buffers,
)
from tramp_tpu_torch.priors import GaussBernoulliPrior

REPO = Path(__file__).resolve().parents[1]
LOOP_SPANS = ("solve", "sweep", "stop_read", "readout")
SOLVERS = {"ep": (EPSolver, False), "vamp": (SpectralVAMPSolver, False),
           "ml_vamp": (MLVAMPSolver, True)}
N, M, LANES = 48, 36, 3


@pytest.fixture(autouse=True)
def fresh_store(monkeypatch):
    monkeypatch.setattr(config, "TRACE", None)
    trace.reset()
    yield
    trace.reset()


def _observations(W, relu, lanes, seed):
    g = torch.Generator().manual_seed(seed)
    x = ((torch.rand(lanes, N, generator=g, dtype=W.dtype) < 0.3)
         * torch.randn(lanes, N, generator=g, dtype=W.dtype))
    z = x @ W.T
    a = z.clamp(min=0) if relu else z
    return a + 0.1 * torch.randn(lanes, M, generator=g, dtype=W.dtype)


def _problem(kind, batched):
    """(solver, model): a float64 GLM (a relu net for ``ml_vamp``) on the
    CPU, with LANES observations under one operator when ``batched``."""
    cls, relu = SOLVERS[kind]
    g = torch.Generator().manual_seed(7)
    W = torch.randn(M, N, generator=g, dtype=torch.float64) / N**0.5
    ys = _observations(W, relu, LANES, seed=11)
    kw = dict(device="cpu", dtype=torch.float64)
    model = (GaussBernoulliPrior(size=N, rho=0.3, **kw) @ tt.V(id="x")
             @ LinearChannel(W, **kw) @ tt.V(id="z"))
    if relu:
        model = model @ ReluChannel() @ tt.V(id="a")
    model = (model @ GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
    student = model.to_observed({"y": ys[0]})
    solver = cls(student, **({"damping": 0.1} if relu else {}))
    if batched:
        likelihood = len(student.factors) - 1
        student = with_buffers(student, {(likelihood, "y"): ys})
    return solver, student


def _solve(solver, model, batched=False):
    "(post, n_iter) of a solve, or of a batched solve."
    return solver.solve_batch(model) if batched else solver.solve(model)


def test_nothing_records_by_default():
    solver, model = _problem("vamp", batched=False)
    _solve(solver, model)
    assert trace.span("solve") is trace.span("sweep")
    assert trace.records() == [] and trace.summary() == {}


def test_nothing_records_with_trace_false_under_a_profiler(monkeypatch):
    monkeypatch.setattr(config, "TRACE", False)
    solver, model = _problem("vamp", batched=False)
    with profile(activities=[ProfilerActivity.CPU]):
        assert not config.trace()
        _solve(solver, model)
    assert trace.records() == [] and trace.summary() == {}


def test_spans_record_under_a_profiler_with_no_range():
    solver, model = _problem("vamp", batched=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(solver, model)
    assert set(trace.summary()) == set(LOOP_SPANS)
    names = {e.name for e in prof.events()}
    assert not {n for n in names if n.startswith(trace.RANGE_PREFIX)}
    assert not names & set(LOOP_SPANS)


def test_trace_true_records_ranges_in_the_profile(monkeypatch):
    monkeypatch.setattr(config, "TRACE", True)
    solver, model = _problem("vamp", batched=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, n_iter = _solve(solver, model)
    names = [e.name for e in prof.events()]
    for name in LOOP_SPANS:
        assert trace.RANGE_PREFIX + name in names
    assert names.count(trace.RANGE_PREFIX + "sweep") == int(n_iter)


def test_span_names_miss_the_kernel_names_the_benchmark_matches():
    groups = json.loads((REPO / "portbench" / "metrics"
                         / "kernel_names.json").read_text())
    matched = [part for key, parts in groups.items() if key != "about"
               for part in parts]
    assert "gemm" in matched and "pl_message" in matched
    names = LOOP_SPANS + ("svd", "kernels.build", "kernels.compile",
                          "kernels.load")
    assert not [n for n in names for m in matched if m in n.lower()]


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("kind", sorted(SOLVERS))
def test_a_solve_records_its_loop(kind, batched, monkeypatch):
    solver, model = _problem(kind, batched)
    monkeypatch.setattr(config, "TRACE", True)
    _, n_iter = _solve(solver, model, batched)
    iterations = int(n_iter.max())
    assert iterations > 1
    records = trace.records()
    solves = [r for r in records if r.name == "solve"]
    assert len(solves) == 1 and solves[0].parent is None
    run = solves[0].solve
    assert run is not None
    counts = {name: 0 for name in LOOP_SPANS}
    for r in records:
        counts[r.name] += 1
        assert r.solve == run and r.start_ns <= r.end_ns
        assert r.name == "solve" or r.parent == "solve"
        assert solves[0].start_ns <= r.start_ns <= r.end_ns \
            <= solves[0].end_ns
    assert counts == {"solve": 1, "sweep": iterations,
                      "stop_read": iterations, "readout": 1}
    summary = trace.summary()
    assert {n: s["count"] for n, s in summary.items()} == counts
    for s in summary.values():
        assert 0 <= s["self_seconds"] <= s["seconds"]
    inside = sum(summary[n]["seconds"] for n in LOOP_SPANS[1:])
    assert summary["solve"]["self_seconds"] == pytest.approx(
        summary["solve"]["seconds"] - inside, abs=1e-9)


@pytest.mark.parametrize("kind", sorted(SOLVERS))
def test_answers_are_bit_equal_with_spans_on_and_off(kind, monkeypatch):
    solver, model = _problem(kind, batched=True)
    answers = []
    for on in (True, False):
        monkeypatch.setattr(config, "TRACE", on)
        answers.append(_solve(solver, model, batched=True))
    (post_on, n_on), (post_off, n_off) = answers
    assert torch.equal(n_on, n_off)
    assert post_on.keys() == post_off.keys()
    for vid in post_on:
        for key in ("r", "v"):
            assert torch.equal(post_on[vid][key], post_off[vid][key])


@pytest.mark.parametrize("switch", [None, False])
def test_an_idle_solve_reads_no_clock_and_allocates_nothing(switch,
                                                            monkeypatch):
    """Every span of a solve with nothing recording is the one shared
    context: no span object is made and no clock is read."""
    solver, model = _problem("ml_vamp", batched=True)
    monkeypatch.setattr(config, "TRACE", switch)
    reads, given = [], []
    span = trace.span
    monkeypatch.setattr(trace, "_clock", lambda: reads.append(1) or 0)
    monkeypatch.setattr(trace, "_Span", None)   # making one would raise
    monkeypatch.setattr(trace, "span",
                        lambda name: given.append(span(name)) or given[-1])
    _, n_iter = _solve(solver, model, batched=True)
    assert len(given) == 2 * int(n_iter.max()) + 2
    assert all(g is given[0] for g in given) and reads == []
    assert trace.records() == [] and trace.summary() == {}


def test_the_store_keeps_its_bound(monkeypatch):
    monkeypatch.setattr(config, "TRACE", True)
    for _ in range(trace.MAX_RECORDS + 5):
        with trace.span("tick"):
            pass
    assert len(trace.records()) == trace.MAX_RECORDS
    assert trace.summary()["tick"]["count"] == trace.MAX_RECORDS + 5


def test_nested_spans_and_reset(monkeypatch):
    monkeypatch.setattr(config, "TRACE", True)
    with trace.span("outer"):
        with trace.span("solve"):
            with trace.span("inner"):
                pass
    inner, solve, outer = trace.records()
    assert (outer.parent, outer.solve) == (None, None)
    assert solve.parent == "outer" and inner.solve == solve.solve
    assert inner.parent == "solve"
    summary = trace.summary()
    assert summary["outer"]["self_seconds"] == pytest.approx(
        summary["outer"]["seconds"] - summary["solve"]["seconds"], abs=1e-9)
    trace.reset()
    assert trace.records() == [] and trace.summary() == {}


def test_the_svd_span_only_where_the_channel_takes_it(monkeypatch):
    monkeypatch.setattr(config, "TRACE", True)
    W = torch.randn(6, 8, dtype=torch.float64)
    channel = LinearChannel(W, device="cpu")
    assert [r.name for r in trace.records()] == ["svd"]
    trace.reset()
    U, s, V = channel.U, channel.s, channel.V
    LinearChannel(W, svd=(U, s, V.T), device="cpu")
    assert trace.records() == []


class _FakeNvcc:
    "Popen of an nvcc that writes its output file and succeeds."

    def __init__(self, cmd, stdout=None, stderr=None):
        self.out = Path(cmd[cmd.index("-o") + 1])
        self.returncode = None

    def wait(self):
        self.out.write_bytes(b"")
        self.returncode = 0
        return 0


def test_the_kernel_build_spans(monkeypatch, tmp_path):
    monkeypatch.setattr(config, "TRACE", True)
    monkeypatch.setattr(pl_fused, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pl_fused, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(pl_fused.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(pl_fused, "_load", lambda jobs: {})
    monkeypatch.setattr(pl_fused, "_fns", {})
    libs, _ = pl_fused.build()
    records = trace.records()
    assert [r.name for r in records] == (["kernels.compile"] * len(libs)
                                         + ["kernels.load", "kernels.build"])
    assert all(r.parent == "kernels.build" for r in records[:-1])
    trace.reset()
    pl_fused.build()    # built already: nothing to compile
    assert [r.name for r in trace.records()] == ["kernels.load",
                                                 "kernels.build"]
