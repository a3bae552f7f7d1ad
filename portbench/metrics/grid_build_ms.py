"""grid_build_ms: the mean host time of the port's ``grid.build`` span
(``tramp_tpu_torch.trace``: the grid's models built and stacked, the solver
made) over the traced calls, in ms. The span lies outside any ``solve``, so
the reader takes the newest ``len(run.traced_calls)`` of them itself: the
harness profiles again when a profile shows no device event, so earlier
attempts may sit before them. Nothing is read from a program that opens no
``grid.build`` span (``trace.NAMES``)."""


def read(run):
    try:
        from tramp_tpu_torch import trace
    except ImportError:
        run.note("grid_build_ms: the program has no tramp_tpu_torch.trace")
        return None
    if "grid.build" not in getattr(trace, "NAMES", ()):
        run.note("grid_build_ms: the program opens no grid.build span")
        return None
    want = len(run.traced_calls)
    spans = [r for r in trace.records() if r.name == "grid.build"][-want:]
    if len(spans) < want or not want:
        run.note(f"grid_build_ms: {len(spans)} grid.build spans, {want} "
                 "traced calls")
        return None
    return 1e-6 * sum(r.end_ns - r.start_ns for r in spans) / want
