"""The readers of the port's own spans (``program_span``): sweep_host_ms,
stop_read_ms and sweep_idle_share, on synthetic span records and a
synthetic profiler trace, and on a traced run of a cell on the CPU."""
import sys
import types

import pytest

from portbench import manifest, program_spans, trace
from portbench.tests.helpers import SMALL
from tramp_tpu_torch.trace import Record as record

US = 1e6            # the profiler's clock is in microseconds
NS = 1e9            # the port's clock is in nanoseconds
SLACK = (1e-5, 4e-5)    # half the harness's solve range less the port's
HOST0 = 5_000.0     # the port's clock at the first traced solve, in s


def _program(solve_id, t0, length, sweep=0.2):
    """The port's records of one solve opening at t0 s on its clock: two
    sweeps of ``sweep`` s, each followed by a stop_read of 0.1 s, and a
    readout; relative to t0: sweeps at 0.1 and 0.4, stop reads at 0.3 and
    0.6 (0.1 + sweep, 0.4 + sweep for the default), readout at 0.8."""
    def rec(name, a, b, parent="solve"):
        return record(name, parent, solve_id, int(round((t0 + a) * NS)),
                      int(round((t0 + b) * NS)))
    out = []
    for a in (0.1, 0.4):
        out += [rec("sweep", a, a + sweep),
                rec("stop_read", a + sweep, a + sweep + 0.1)]
    out.append(rec("readout", 0.8, 0.85))
    out.append(rec("solve", 0.0, length, parent=None))
    return out


def _records():
    """An earlier attempt's two solves (sweeps of 0.05 s), then the two
    traced calls' solves, each 2 * SLACK[k] shorter than the harness's
    0.9 s range."""
    out = []
    for i in range(2):
        out += _program(i + 1, 100.0 + i, 0.8, sweep=0.05)
    for k in range(2):
        out += _program(k + 3, HOST0 + 3.0 * k, 0.9 - 2 * SLACK[k])
    return out


def _events():
    """Two program windows of 1 s at 0 and 2 s: the harness's solve 0.9 s,
    then its readout; the device busy but for gaps that fall, once mapped,
    in the first sweep (0.10 s), the first stop read (0.12 s), the second
    sweep (0.15 s) and the port's readout (0.03 s)."""
    out = []
    for k, t in enumerate((0.0, 2.0)):
        def at(rel):
            return (t + SLACK[k] + rel) * US
        out += [("portbench.program", False, t * US, (t + 1.0) * US),
                ("portbench.solve", False, t * US, (t + 0.9) * US),
                ("portbench.readout", False, (t + 0.9) * US,
                 (t + 1.0) * US)]
        busy = [(t * US, at(0.15)), (at(0.25), at(0.33)),
                (at(0.45), at(0.5)), (at(0.65), at(0.81)),
                (at(0.84), (t + 1.0) * US)]
        out += [("kernel", True, a, b) for a, b in busy]
    return out


def _run(calls=2, records=_records, monkeypatch=None):
    notes = []
    run = types.SimpleNamespace(
        timeline=trace.Timeline.from_events(_events()),
        traced_calls=[{}] * calls, note=notes.append)
    monkeypatch.setattr("tramp_tpu_torch.trace.records", records)
    return run, notes


def read(name, run):
    return manifest.metric_reader(name).read(run)


def test_the_last_solves_are_the_traced_calls(monkeypatch):
    run, _ = _run(monkeypatch=monkeypatch)
    spans = program_spans.solves(run)
    assert [call[0].solve for call in spans] == [3, 4]
    assert read("sweep_host_ms", run) == pytest.approx(200.0)
    assert read("stop_read_ms", run) == pytest.approx(100.0)


def test_the_mapping_onto_the_profiler_clock(monkeypatch):
    run, _ = _run(monkeypatch=monkeypatch)
    mapped, harness, errors = program_spans.on_profiler_clock(
        run, program_spans.solves(run))
    assert harness == [pytest.approx((0.0, 0.9)), pytest.approx((2.0, 2.9))]
    assert errors == pytest.approx(list(SLACK))
    for k, t in enumerate((0.0, 2.0)):
        spans = {(name, round(a - t - SLACK[k], 6)): b - a
                 for name, a, b in mapped[k]}
        assert spans[("solve", 0.0)] == pytest.approx(0.9 - 2 * SLACK[k])
        assert spans[("sweep", 0.4)] == pytest.approx(0.2)
        assert spans[("readout", 0.8)] == pytest.approx(0.05)


def test_each_gap_goes_to_the_innermost_span_at_its_midpoint(monkeypatch):
    run, notes = _run(monkeypatch=monkeypatch)
    idle = program_spans.idle_by_span(run, program_spans.solves(run))
    assert idle == {"sweep": pytest.approx(2 * 0.25),
                    "stop_read": pytest.approx(2 * 0.12),
                    "readout": pytest.approx(2 * 0.03)}
    assert any("mapping error at most 0.0400 ms" in n for n in notes)
    share = read("sweep_idle_share", run)
    assert share == pytest.approx(100.0 * 0.5 / 2.0)
    assert share <= read("device_idle_share", run)
    spans = sorted([("solve", 0.0, 1.0), ("sweep", 0.2, 0.4),
                    ("sweep", 0.0, 0.1)], key=lambda s: (s[1], -s[2]))
    starts = [s[1] for s in spans]
    assert [program_spans.innermost(spans, starts, t)
            for t in (0.05, 0.15, 0.3, 0.5, 1.5)] == [
        "sweep", "solve", "sweep", "solve", None]


def test_nothing_is_read_on_a_count_mismatch(monkeypatch):
    run, notes = _run(calls=2, records=lambda: _program(9, HOST0, 0.9),
                      monkeypatch=monkeypatch)
    for name in ("sweep_host_ms", "stop_read_ms", "sweep_idle_share"):
        assert read(name, run) is None
    assert "program spans: 1 solves recorded, 2 traced calls" in notes
    run, notes = _run(calls=3, monkeypatch=monkeypatch)   # 4 solves held
    assert read("sweep_idle_share", run) is None
    assert "program spans: 2 solve ranges in the trace, 3 solves " \
        "recorded" in notes


def test_nothing_is_read_without_the_port_s_spans(monkeypatch):
    import tramp_tpu_torch
    run, notes = _run(monkeypatch=monkeypatch)
    monkeypatch.delattr(tramp_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "tramp_tpu_torch.trace", None)
    for name in ("sweep_host_ms", "stop_read_ms", "sweep_idle_share"):
        assert read(name, run) is None
    assert "program spans: the program has no tramp_tpu_torch.trace" \
        in notes


def test_a_traced_run_on_the_cpu_reports_the_host_spans():
    """A traced run of the relu lanes on the CPU: the two host readings,
    and no sweep_idle_share, since the CPU profile holds no device event."""
    from portbench import run
    result = run.main(
        ["--workload", "relu_net_f64.lanes2048", "--seed", "3000000021",
         "--seconds", "0.3", "--trace", "1"], device="cpu",
        overrides=dict(SMALL, traffic={"lanes": 4}, cell={
            "check": {"calls": 2, "lanes_per_call": 3}, "trace_calls": 1}))
    assert result["correct"] is True
    metrics = result["metrics"]
    assert metrics["sweep_host_ms"]["value"] > 0
    assert metrics["sweep_host_ms"]["unit"] == "ms"
    assert 0 < metrics["stop_read_ms"]["value"] \
        < metrics["sweep_host_ms"]["value"]
    assert "sweep_idle_share" not in metrics
