"""The SE phase-grid cell ``cs_glm_se.grid1030`` on the CPU at a small grid
(the harness's own entry point, float64): the kind's records, the three
readers of the cell (and that each reads nothing from a program without
its span or counter), a sound run that is correct, and three breaks of the
timed path that each make ``correct`` false. On the card, the float32
control fails the check:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        portbench/tests/test_portbench_cs_glm_se.py
"""
import types

import pytest
import torch

from portbench import counts, manifest
from tramp_tpu_torch import config, trace
from tramp_tpu_torch.algos import StateEvolution
from tramp_tpu_torch.parallel import SESolver

CELL = "cs_glm_se.grid1030"
#: a 15 x 3 grid: 12 alphas and the 3 golden ones, rhos 0.05, 0.25, 0.45;
#: the check samples 2 calls
SMALL = {"config": {"alphas": {"start": 0.1, "stop": 1.6, "num": 12},
                    "rhos": {"start": 0.05, "stop": 0.45, "num": 3}},
         "cell": {"check": dict(manifest.Cell(CELL).cell["check"],
                                calls=2)}}
POINTS = 45


def small_run(monkeypatch, seed=3_000_000_019, seconds=0.5, trace_=0):
    """``run.main`` on the CPU at the small grid; returns (result, the
    records of the run's calls)."""
    from portbench import run
    calls = []
    plain = run._call

    def call(r, traffic, profiled=False):
        calls.append(plain(r, traffic, profiled))
        return calls[-1]
    monkeypatch.setattr(run, "_call", call)
    result = run.main(["--workload", CELL, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace_)],
                      device="cpu", overrides=SMALL)
    return result, calls


@pytest.fixture(autouse=True)
def fresh_store(monkeypatch):
    monkeypatch.setattr(config, "TRACE", None)
    trace.reset()
    yield
    trace.reset()


def test_a_sound_run_is_correct_and_its_records_are_whole(monkeypatch):
    result, calls = small_run(monkeypatch)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"v_gap", "golden_gap"}
    assert result["checks"]["v_gap"]["value"] == 0.0   # the same bits here
    assert result["failed"] == 0 and result["attempted"] == POINTS * len(
        calls)
    for c in calls:
        assert set(c) == {"lanes", "solved", "n_iter_sum", "iterations",
                          "seconds", "quad_nodes", "wall", "profiled"}
        assert c["lanes"] == c["solved"] == POINTS
        assert POINTS * 2 <= c["n_iter_sum"] <= POINTS * c["iterations"]
        # every sweep averages the prior over 2 x 640 nodes for each point
        assert c["quad_nodes"] == c["iterations"] * POINTS * 1280
    assert set(result["metrics"]) == {"instances_per_s", "setup_s"}


def test_a_traced_run_reads_the_cells_metrics(monkeypatch):
    result, _ = small_run(monkeypatch, trace_=1)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in ("iters_per_instance", "sweep_host_ms", "stop_read_ms",
                 "grid_build_ms", "quad_nodes_per_iter", "se_grid_mfu"):
        assert metrics[name]["value"] > 0, name
    assert metrics["quad_nodes_per_iter"]["value"] == POINTS * 1280


def fake_run(calls, traced):
    cell = manifest.Cell(CELL)
    return types.SimpleNamespace(
        calls=calls, traced_calls=traced, config=cell.config,
        config_module=cell.config_module, note=lambda line: None)


def read(name, run):
    return manifest.metric_reader(name).read(run)


def test_the_readers_and_what_they_read_without_the_program(monkeypatch):
    calls = [{"lanes": 1030, "solved": 1029, "n_iter_sum": 6000 + i,
              "iterations": 100 + i, "seconds": 1.0, "wall": 1.2,
              "quad_nodes": (100 + i) * 1030 * 1280,
              "profiled": i in (1, 2)} for i in range(6)]
    run = fake_run(calls, calls[1:3])
    assert read("quad_nodes_per_iter", run) == 1030 * 1280
    want = (100.0 * 33_435 * (6000 * 4 + 0 + 3 + 4 + 5)
            / (counts.PEAK_FLOPS["float64"] * 4 * 1.2))
    assert read("se_grid_mfu", run) == pytest.approx(want)
    monkeypatch.setattr(config, "TRACE", True)
    for ms in (3, 5, 7):   # an earlier profile's grid, then two traced
        with trace.span("grid.build"):
            pass
        record = trace.records()[-1]
        trace._records[-1] = record._replace(end_ns=record.start_ns
                                             + ms * 10**6)
    assert read("grid_build_ms", run) == pytest.approx(6.0)
    # a program without the counter, the span or its record
    for c in calls:
        c["quad_nodes"] = None
    assert read("quad_nodes_per_iter", run) is None
    trace.reset()
    assert read("grid_build_ms", run) is None
    monkeypatch.setattr(trace, "NAMES", tuple(
        n for n in trace.NAMES if not n.startswith("grid.")))
    assert read("grid_build_ms", run) is None


def state_unchanged(monkeypatch):
    "A sweep that returns its state unchanged."
    monkeypatch.setattr(StateEvolution, "_sweep",
                        lambda self, model, state, damp, aux=None, **kw:
                        state)


def _wrap_solve_batch(monkeypatch, change):
    plain = SESolver.solve_batch

    def solve_batch(self, stacked_model, initializer=None, state=None):
        return change(*plain(self, stacked_model, initializer, state))
    monkeypatch.setattr(SESolver, "solve_batch", solve_batch)


def half_left_out(monkeypatch):
    """Half of the grid left out: the second half of the points gets the
    first half's answers."""
    def change(post, n_iter):
        B = n_iter.shape[0]
        h = B // 2

        def fill(x):
            x = x.clone()
            x[h:] = x[:B - h].clone()
            return x
        return ({vid: {k: fill(v) for k, v in d.items()}
                 for vid, d in post.items()}, fill(n_iter))
    _wrap_solve_batch(monkeypatch, change)


def answer_altered(monkeypatch):
    "An answer altered where it is produced: one point's v by 1e-4 of it."
    def change(post, n_iter):
        v = post["x"]["v"].clone()
        v[0] *= 1.0 + 1e-4
        return dict(post, x=dict(post["x"], v=v)), n_iter
    _wrap_solve_batch(monkeypatch, change)


FAULTS = {"state_unchanged": state_unchanged,
          "half_left_out": half_left_out,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_makes_the_run_incorrect(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, _ = small_run(monkeypatch, seconds=0.2)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_the_float32_control_fails_the_check():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.control_se import control_readings
    cell = manifest.Cell(CELL)
    limits = cell.cell["limits"]
    for seed in (101, 2**33 + 5, 3_000_000_123):
        numbers = control_readings(cell, seed, "cuda")[0]
        assert any(not value <= limits[name] for name, value in numbers), (
            seed, numbers)
