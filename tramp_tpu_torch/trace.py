"""Spans of the port's own work, on the host's clock.

``span(name)`` is a context manager that marks a stretch of host time. The
solver loops of ``parallel`` open these spans:

- ``solve``: a whole run of a loop (``parallel.loop.SolverLoop._run``,
  which every batched solver runs), the SE grid's too;
- ``sweep``: one iteration, the step and the masks, everything before the
  stop test: the host's time to enqueue it;
- ``replay``: inside ``sweep``, the launch of a captured CUDA graph that
  holds the whole iteration (``parallel.loop.Plan``: ``MLVAMPSolver``,
  ``EPSolver`` and ``SESolver`` on the card), where there is one;
  ``capture``, inside the first ``sweep`` of a new graph, that iteration run
  eagerly and the capture;
- ``stop_read``: the loop's one host read (``parallel.mesh.all_done``, with
  its ``all_reduce`` on a mesh): how long the loop waits on the device;
- ``readout``: the posteriors after the loop.

The SE phase grids (``parallel/grid.py``) open ``grid.build`` (the points'
models built and stacked, the solver made) and ``grid.records`` (the
answers read back and made records) around their solve.

Set-up opens ``svd`` (``LinearChannel`` taking W's SVD itself) and
``kernels.build`` (``ops.pl_fused.build``), whose children are
``kernels.compile`` (the wait on nvcc, one per library built) and
``kernels.load`` (the ``ctypes`` loads).

What is recorded stays in memory. ``records()`` gives the spans kept, the
newest ``MAX_RECORDS``, each with its name, its parent's name, the id of
the ``solve`` it belongs to (one per run of a loop, shared by its spans)
and its start and end from ``time.perf_counter_ns()``. ``summary()`` gives
the totals by name, which are not bounded: count, seconds and self seconds
(a span's time less what its child spans cover). ``reset()`` clears both.

``config.TRACE``, resolved by ``config.trace()``, says when spans record:

- None (the default): while a ``torch.profiler`` records, on the host's
  clock alone. No ``record_function`` range is opened, so the profiler's
  device timeline holds the device's work and nothing of the program's; a
  reader maps the spans onto the profiler's clock through a range of its
  own around the solve.
- True: always; each span is also a ``record_function`` range named
  ``tramp_tpu_torch.<name>``, so a trace exported from ``torch.profiler``
  shows it over the kernels it launched, on the device's clock.
- False: never.

When nothing records, ``span`` returns one shared context that does
nothing: it reads no clock and allocates nothing.

Where a solve's host time goes::

    from tramp_tpu_torch import config, trace
    config.TRACE = True
    solver.solve(model)
    trace.summary()   # {"readout": {...}, "solve": {...}, "sweep": ...}

Spans nest in the order they open; the port's loops run in one thread.
"""
import collections
import contextlib
import itertools
import time

from . import config

#: most span records kept (the totals of ``summary`` are not bounded)
MAX_RECORDS = 50_000
#: prefix of the ``record_function`` ranges opened with ``config.TRACE`` True
RANGE_PREFIX = "tramp_tpu_torch."

#: the names of the spans the port opens
NAMES = ("solve", "sweep", "replay", "capture", "stop_read", "readout",
         "grid.build", "grid.records", "svd", "kernels.build",
         "kernels.compile", "kernels.load")
#: one recorded span; ``solve`` is None outside any solve
Record = collections.namedtuple("Record",
                                "name parent solve start_ns end_ns")

_clock = time.perf_counter_ns
_OFF = contextlib.nullcontext()
_records = collections.deque(maxlen=MAX_RECORDS)
# name: [count, ns, self ns]
_totals = {}
# the recording spans open now, innermost last
_open = []
_solve_ids = itertools.count(1)


def span(name):
    """The span ``name``: a context that records it when ``config.trace()``
    says so, else the shared context that does nothing."""
    if not config.trace():
        return _OFF
    return _Span(name, config.TRACE is True)


class _Span:
    __slots__ = ("name", "parent", "solve", "start", "children", "range")

    def __init__(self, name, ranged):
        self.name = name
        self.range = None
        if ranged:
            from torch.profiler import record_function
            self.range = record_function(RANGE_PREFIX + name)

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.parent = None if outer is None else outer.name
        if self.name == "solve":
            self.solve = next(_solve_ids)
        else:
            self.solve = None if outer is None else outer.solve
        self.children = 0
        if self.range is not None:
            self.range.__enter__()
        _open.append(self)
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        _open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        ns = end - self.start
        if _open:
            _open[-1].children += ns
        _records.append(Record(self.name, self.parent, self.solve,
                               self.start, end))
        total = _totals.setdefault(self.name, [0, 0, 0])
        total[0] += 1
        total[1] += ns
        total[2] += ns - self.children
        return False


def records():
    "The spans kept, oldest first: a list of ``Record``."
    return list(_records)


def summary():
    """{name: {"count", "seconds", "self_seconds"}} of every span recorded
    since the last ``reset``."""
    return {name: {"count": count, "seconds": 1e-9 * ns,
                   "self_seconds": 1e-9 * own}
            for name, (count, ns, own) in sorted(_totals.items())}


def reset():
    "Forget the spans kept and the totals."
    _records.clear()
    _totals.clear()
