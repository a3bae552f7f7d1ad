"""The plan's path of ``parallel.loop`` on the CPU, for the tests of the
solver loops: ``stand_in_graphs`` replaces ``Plan``'s capture by a graph
whose replay runs the iteration on the plan's buffers, and opens the graph
path where the model is on the CPU."""
import pytest

from tramp_tpu_torch.parallel import loop


class _CallGraph:
    """Stands in for a captured graph on the CPU: a replay runs the
    iteration, and the counters advance by the captured counts
    (``Plan.step``), not by the iteration run here."""

    def __init__(self, iterate):
        self.iterate = iterate

    def replay(self):
        kept = [getattr(o, a) for o, a in loop.COUNTERS]
        self.iterate()
        for (o, a), n in zip(loop.COUNTERS, kept):
            setattr(o, a, n)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """The graph path on the CPU, counted as a capture counts: once, the
    count added on every replay."""
    def capture(plan, solver):
        before = [getattr(o, a) for o, a in loop.COUNTERS]
        plan._iterate(solver)
        plan.graph = _CallGraph(lambda: plan._iterate(solver))
        plan.counts = [(o, a, getattr(o, a) - n)
                       for (o, a), n in zip(loop.COUNTERS, before)]
    monkeypatch.setattr(loop.Plan, "_capture", capture)
    monkeypatch.setattr(loop, "why_eager", lambda model, device, groups: None)
