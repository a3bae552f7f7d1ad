"""sweep_idle_share: the device's idle time inside the traced calls'
program windows during which the host was in a ``sweep`` span of the port,
over the windows' time, in %; at most ``device_idle_share``. Each idle gap
goes to the innermost span of the port at its midpoint, the port's spans
mapped onto the profiler's clock through the harness's ``solve`` ranges
(``portbench/program_spans.py``)."""
from portbench.program_spans import idle_by_span, solves


def read(run):
    if run.timeline is None or not run.timeline.device:
        return None
    spans = solves(run)
    idle = None if spans is None else idle_by_span(run, spans)
    if idle is None:
        return None
    return 100.0 * idle.get("sweep", 0.0) / run.timeline.window_s
