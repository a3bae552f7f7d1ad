"""The relu SE cell ``relu_se.lanes1024`` on the CPU at a small grid (the
harness's own entry point, float64): a sound run that is correct, with its
records and its traced metrics; three breaks of the timed path that each
make ``correct`` false (a float32 solve, one region of the relu channel's
measure left out, the loop stopped one sweep early); the readers of
``pl_posterior_roofline`` on a synthetic trace and ``se_nodes_per_iter``
without the program's span; and a plain reference that loads neither the
port nor JAX. On the card, the float32 control fails the check:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        portbench/tests/test_portbench_relu_se.py
"""
import subprocess
import sys

import pytest
import torch

from portbench import counts, manifest, trace
from portbench.tests.helpers import ROOT
from portbench.tests.test_portbench_readers import events, fake_run, read
from tramp_tpu_torch import config
from tramp_tpu_torch import trace as port_trace
from tramp_tpu_torch.channels.piecewise_linear_channel import (
    PiecewiseLinearChannel,
)
from tramp_tpu_torch.parallel import SESolver

CELL = "relu_se.lanes1024"
#: a 4 x 3 grid; the check samples 2 calls
SMALL = {"config": {"alphas": {"start": 0.1, "stop": 2.0, "num": 4},
                    "rhos": {"start": 0.05, "stop": 0.95, "num": 3}},
         "cell": {"check": dict(manifest.Cell(CELL).cell["check"],
                                calls=2)}}
POINTS = 12
US = 1e6


def small_run(monkeypatch, seed=3_000_000_023, seconds=0.5, trace_=0,
              overrides=None):
    """``run.main`` on the CPU at the small grid; returns (result, the
    records of the run's calls)."""
    from portbench import run
    calls = []
    plain = run._call

    def call(r, traffic, profiled=False):
        calls.append(plain(r, traffic, profiled))
        return calls[-1]
    monkeypatch.setattr(run, "_call", call)
    small = {k: dict(v) for k, v in SMALL.items()}
    for key, values in (overrides or {}).items():
        small.setdefault(key, {}).update(values)
    result = run.main(["--workload", CELL, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace_)],
                      device="cpu", overrides=small)
    return result, calls


@pytest.fixture(autouse=True)
def fresh_store(monkeypatch):
    monkeypatch.setattr(config, "TRACE", None)
    port_trace.reset()
    yield
    port_trace.reset()


def test_a_sound_run_is_correct_and_reads_the_cells_metrics(monkeypatch):
    result, calls = small_run(monkeypatch, trace_=1)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"v_gap"}
    assert result["checks"]["v_gap"]["value"] < 1e-12
    assert result["failed"] == 0 and result["attempted"] == POINTS * len(
        calls)
    for c in calls:
        assert c["lanes"] == c["solved"] == POINTS
        assert POINTS * 2 <= c["n_iter_sum"] <= POINTS * c["iterations"]
        assert c["quad_nodes"] == c["iterations"] * POINTS * 41_280
    metrics = result["metrics"]
    assert metrics["se_nodes_per_iter"]["value"] == POINTS * 41_280
    for name in ("iters_per_instance", "sweep_host_ms", "stop_read_ms",
                 "relu_se_mfu"):
        assert metrics[name]["value"] > 0, name


def float32_solve(monkeypatch):
    "The program solves in float32 (the reference stays in float64)."
    return {"config": {"dtype": "float32"}}


def region_left_out(monkeypatch):
    "The relu channel's measure leaves its z < 0 region out."
    plain = PiecewiseLinearChannel.regions

    monkeypatch.setattr(PiecewiseLinearChannel, "regions", property(
        lambda self: plain.fget(self)[:1]))


def one_sweep_early(monkeypatch):
    """The loop stops one sweep before the call's slowest point stops: the
    solve again with max_iter one below its iterations."""
    plain = SESolver.solve_batch

    def solve_batch(self, stacked_model, initializer=None, state=None):
        _, n_iter = plain(self, stacked_model, initializer, state)
        keep, self.max_iter = self.max_iter, int(n_iter.max()) - 1
        try:
            return plain(self, stacked_model, initializer, state)
        finally:
            self.max_iter = keep
    monkeypatch.setattr(SESolver, "solve_batch", solve_batch)


FAULTS = {"float32_solve": float32_solve, "region_left_out": region_left_out,
          "one_sweep_early": one_sweep_early}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_makes_the_run_incorrect(fault, monkeypatch):
    overrides = FAULTS[fault](monkeypatch)
    result, _ = small_run(monkeypatch, seconds=0.2, overrides=overrides)
    assert not result["correct"], result["checks"]


def _with_posterior_kernels(duration_s, launches_per_window=2):
    out = list(events())
    for t in (0.0, 2.0):
        out += [("void (anonymous namespace)::pl_posterior_kernel"
                 "<double, 2, true>(double const*, long, ...)", True,
                 (t + 0.75 + k * duration_s) * US,
                 (t + 0.75 + (k + 1) * duration_s) * US)
                for k in range(launches_per_window)]
    return trace.Timeline.from_events(out)


def _run(**kw):
    run = fake_run(lanes=1024, config=CELL, **kw)
    run.launches = dict(run.launches, pl_posterior=4)
    return run


def test_the_roofline_reader_over_the_counted_launches():
    run = _run()
    run.timeline = _with_posterior_kernels(1e-3)
    bound_ms = counts.bound_ms("pl_posterior", counts.RELU_SPECS, 20_000,
                               "float64", lanes=1024)[0]
    # four launches of 1 ms, each with the bound of one
    assert read("pl_posterior_roofline", run) == pytest.approx(
        100.0 * 4 * bound_ms * 1e-3 / 4e-3)
    assert 30.0 < read("pl_posterior_roofline", run) < 40.0


def test_the_roofline_reader_reads_nothing_it_cannot_match():
    notes = []
    run = _run()
    run.note = notes.append
    assert read("pl_posterior_roofline", run) is None   # no such kernel
    assert notes and "0 kernels" in notes[0]
    run.timeline = _with_posterior_kernels(1e-3, launches_per_window=1)
    assert read("pl_posterior_roofline", run) is None   # 2 traced, 4 counted
    assert read("pl_posterior_roofline", _run(timeline=False)) is None


def test_the_nodes_reader_without_the_programs_span(monkeypatch):
    run = _run()
    for c in run.calls:
        c["quad_nodes"] = c["iterations"] * 1024 * 41_280
    assert read("se_nodes_per_iter", run) == 1024 * 41_280
    monkeypatch.setattr(port_trace, "NAMES", tuple(
        n for n in port_trace.NAMES if n != "se.channel_measure"))
    assert read("se_nodes_per_iter", run) is None


def test_the_reference_loads_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference.relu_se; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tramp_tpu', 'tramp_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_the_float32_control_fails_the_check():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.control_relu_se import control_readings
    cell = manifest.Cell(CELL)
    limits = cell.cell["limits"]
    for seed in (101, 2**33 + 5):
        numbers = control_readings(cell, seed, "cuda")[0]
        assert any(not value <= limits[name] for name, value in numbers), (
            seed, numbers)
