"""The port's own spans over the traced calls, for the readers whose source
is ``program_span``.

The port records its spans (``tramp_tpu_torch.trace``) on the host's clock
while a profiler records, and opens no range on the profiler's timeline,
so that nothing of the program's counts as device work. ``solves`` takes
the spans of the last ``len(run.traced_calls)`` solves the port holds: the
harness profiles again when a profile shows no device event, so earlier
attempts may sit before them.

``on_profiler_clock`` maps each traced call's spans onto the profiler's
clock through the harness's ``solve`` range of that call, [s_h, e_h],
which holds the program's ``solve`` span, [s_p, e_p]: a program time t
maps to s_h + (t - s_p) + ((e_h - s_h) - (e_p - s_p)) / 2, the program's
solve centred in the harness's. The mapping is off by at most half the
difference of the two lengths, which it returns for each call.
"""
import bisect


def solves(run):
    """[[record]] of the spans of each traced call's solve, oldest first
    (``tramp_tpu_torch.trace.Record``); None, with a note, where the program
    records no spans or fewer solves than the run traced calls."""
    try:
        from tramp_tpu_torch import trace
    except ImportError:
        run.note("program spans: the program has no tramp_tpu_torch.trace")
        return None
    by_solve = {}
    for record in trace.records():
        if record.solve is not None:
            by_solve.setdefault(record.solve, []).append(record)
    # a solve's id is drawn when it opens: later solves have larger ids
    ids = sorted(i for i, spans in by_solve.items()
                 if any(r.name == "solve" and r.parent is None
                        for r in spans))
    want = len(run.traced_calls)
    if len(ids) < want or not want:
        run.note(f"program spans: {len(ids)} solves recorded, {want} "
                 "traced calls")
        return None
    return [by_solve[i] for i in ids[-want:]]


def mean_ms(run, name):
    "The mean length of the spans ``name`` over the traced calls, in ms."
    spans = solves(run)
    if spans is None:
        return None
    lengths = [r.end_ns - r.start_ns for call in spans for r in call
               if r.name == name]
    if not lengths:
        run.note(f"program spans: no {name} span in the traced calls")
        return None
    return 1e-6 * sum(lengths) / len(lengths)


def on_profiler_clock(run, spans):
    """([[(name, start, end)]] of each traced call's spans in seconds on the
    profiler's clock, [(start, end)] of the harness's solve ranges, [the
    mapping's error bound of each call in seconds]); None, with a note,
    where the trace holds another number of the harness's solve ranges
    than calls."""
    harness = sorted((start, end) for name, start, end in run.timeline.spans
                     if name == "solve")
    if len(harness) != len(spans):
        run.note(f"program spans: {len(harness)} solve ranges in the trace, "
                 f"{len(spans)} solves recorded")
        return None
    mapped, errors = [], []
    for (s_h, e_h), call in zip(harness, spans):
        solve = [r for r in call if r.name == "solve" and r.parent is None][0]
        s_p, e_p = 1e-9 * solve.start_ns, 1e-9 * solve.end_ns
        slack = 0.5 * ((e_h - s_h) - (e_p - s_p))
        errors.append(slack)
        shift = s_h - s_p + slack
        mapped.append([(r.name, 1e-9 * r.start_ns + shift,
                        1e-9 * r.end_ns + shift) for r in call])
    return mapped, harness, errors


def innermost(spans, starts, t):
    """The name of the innermost of nested ``spans`` [(name, start, end)]
    that holds the time t, None where none does; ``spans`` sorted by start
    (an outer span before an inner one that opens with it), ``starts``
    their starts."""
    # of the spans that hold t, the innermost opened last
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if t < spans[i][2]:
            return spans[i][0]
    return None


def idle_by_span(run, spans):
    """{span name: seconds} of the device's idle gaps in the traced windows,
    each gap given to the innermost program span at its midpoint (None:
    outside every program span); None, with a note, where the calls cannot
    be mapped. Notes the largest mapping error."""
    found = on_profiler_clock(run, spans)
    if found is None:
        return None
    mapped, harness, errors = found
    run.note("program spans: mapping error at most "
             f"{1e3 * max(map(abs, errors)):.4f} ms per call (by call, ms: "
             + ", ".join(f"{1e3 * e:.4f}" for e in errors) + ")")
    ordered = [sorted(call, key=lambda s: (s[1], -s[2])) for call in mapped]
    starts = [[start for _, start, _ in call] for call in ordered]
    calls = [start for start, _ in harness]
    idle = {}
    for g0, g1 in run.timeline.gaps():
        t = 0.5 * (g0 + g1)
        k = bisect.bisect_right(calls, t) - 1
        name = (innermost(ordered[k], starts[k], t)
                if k >= 0 and t < harness[k][1] else None)
        idle[name] = idle.get(name, 0.0) + (g1 - g0)
    run.note("program spans: device idle by span (s): " + ", ".join(
        f"{name} {seconds!r}" for name, seconds in sorted(
            idle.items(), key=lambda kv: -kv[1])))
    return idle
