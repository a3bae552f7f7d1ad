"""The reader of sweep_graph_share on synthetic span records of the port:
every sweep replayed reads 100, none 0, half 50; no spans, or a program
that opens no replay span, read nothing, with a note."""
import types

from portbench import manifest
from tramp_tpu_torch.trace import Record as record

NS = 1e9            # the port's clock is in nanoseconds


def _solve(solve_id, t0, replayed):
    """The port's records of one solve opening at t0 s: a sweep per entry
    of ``replayed``, each holding a replay span where the entry is true,
    each followed by a stop read; the readout and the solve."""
    def rec(name, a, b, parent):
        return record(name, parent, solve_id, int(round((t0 + a) * NS)),
                      int(round((t0 + b) * NS)))
    out = []
    for k, replay in enumerate(replayed):
        a = 0.1 + 0.3 * k
        if replay:
            out.append(rec("replay", a + 0.01, a + 0.02, "sweep"))
        out += [rec("sweep", a, a + 0.2, "solve"),
                rec("stop_read", a + 0.2, a + 0.3, "solve")]
    end = 0.1 + 0.3 * len(replayed)
    out += [rec("readout", end, end + 0.05, "solve"),
            rec("solve", 0.0, end + 0.1, None)]
    return out


def _run(monkeypatch, *calls):
    """A run whose traced calls' solves replayed as ``calls`` say (one list
    of flags per call, one flag per sweep)."""
    notes = []
    records = [r for i, replayed in enumerate(calls)
               for r in _solve(i + 1, 10.0 * i, replayed)]
    monkeypatch.setattr("tramp_tpu_torch.trace.records", lambda: records)
    run = types.SimpleNamespace(traced_calls=[{}] * len(calls),
                                note=notes.append)
    return run, notes


def read(run):
    return manifest.metric_reader("sweep_graph_share").read(run)


def test_every_sweep_replayed_reads_100(monkeypatch):
    run, _ = _run(monkeypatch, [True] * 3, [True] * 5)
    assert read(run) == 100.0


def test_no_sweep_replayed_reads_0(monkeypatch):
    run, _ = _run(monkeypatch, [False] * 3, [False] * 5)
    assert read(run) == 0.0


def test_the_share_counts_sweeps_over_every_traced_call(monkeypatch):
    run, _ = _run(monkeypatch, [True, False, False], [True] * 3)
    assert read(run) == 100.0 * 4 / 6


def test_no_spans_read_nothing(monkeypatch):
    run, notes = _run(monkeypatch)
    run.traced_calls = [{}, {}]
    assert read(run) is None
    assert any("program spans: 0 solves recorded" in n for n in notes)


def test_no_sweep_span_reads_nothing(monkeypatch):
    run, notes = _run(monkeypatch, [], [])
    assert read(run) is None
    assert "sweep_graph_share: no sweep span in the traced calls" in notes


def test_a_program_without_the_replay_span_reads_nothing(monkeypatch):
    run, notes = _run(monkeypatch, [False] * 3)
    monkeypatch.setattr("tramp_tpu_torch.trace.NAMES",
                        ("solve", "sweep", "stop_read", "readout"))
    assert read(run) is None
    assert "sweep_graph_share: the program opens no replay span" in notes
