"""Spans, the profiler's trace, and what the harness reduces from them.

The harness records a span around each of its calls into the program
(``draw``, ``build_model``, ``solve``, ``readout``; ``program`` covers
``solve`` and ``readout``). The spans of every call are kept in memory
(``Spans``: counts and seconds by name, written at exit). In a traced run
the same spans are ``torch.profiler.record_function`` ranges, so they share
the profiler's clock with the device's events, and ``Timeline`` turns the
profile into the timeline the per-layer readers take: the device's
intervals (kernels, copies and sets) inside the program's windows, and the
host's span at each idle gap.

The device reading follows chip_smoke.py's ``device_events`` (the events
whose ``device_type`` is CUDA, their ``time_range`` in microseconds).
"""
import contextlib
import time

PREFIX = "portbench."
#: device events that move or set memory, not kernels
NOT_KERNELS = ("memcpy", "memset")


class Spans:
    """Count and seconds of every span, by name, on the host's clock; as
    ``record_function`` ranges too while ``profiling`` is set."""

    def __init__(self):
        self.seconds = {}
        self.counts = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name):
        ranged = contextlib.nullcontext()
        if self.profiling:
            from torch.profiler import record_function
            ranged = record_function(PREFIX + name)
        t0 = time.perf_counter()
        with ranged:
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + (
            time.perf_counter() - t0)
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {name: {"count": self.counts[name],
                       "seconds": self.seconds[name]}
                for name in sorted(self.seconds)}


class Timeline:
    """The profile of a traced run, reduced: ``device`` [(name, start, end)]
    of every device event inside a program window, ``windows`` [(start,
    end)] of the ``program`` spans, ``spans`` [(name, start, end)] of the
    harness's other spans, times in seconds on the profiler's clock."""

    def __init__(self, device, windows, spans):
        self.device = device
        self.windows = windows
        self.spans = spans

    @classmethod
    def from_events(cls, events):
        """From ``(name, is_device, start_us, end_us)`` tuples, as
        ``profile.events()`` gives them (``read_profile``)."""
        windows, spans, device = [], [], []
        for name, on_device, start, end in events:
            start, end = 1e-6 * start, 1e-6 * end
            if name.startswith(PREFIX):
                # the profiler copies each range onto the device's timeline
                # as an annotation: no work of the device
                if on_device:
                    continue
                if name == PREFIX + "program":
                    windows.append((start, end))
                spans.append((name[len(PREFIX):], start, end))
            elif on_device:
                device.append((name, start, end))
        windows.sort()
        inside = [e for e in device if _within(e[1], windows)]
        return cls(inside, windows, spans)

    @property
    def window_s(self):
        return sum(end - start for start, end in self.windows)

    def kernels(self):
        "The device events that are kernels (not copies or sets)."
        return [e for e in self.device
                if not e[0].lower().startswith(NOT_KERNELS)]

    def busy(self):
        """The union of the device's intervals, clipped to the windows:
        [(start, end)]."""
        merged = []
        for _, start, end in sorted(self.device, key=lambda e: e[1]):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        clipped = []
        for start, end in merged:
            for w0, w1 in self.windows:
                lo, hi = max(start, w0), min(end, w1)
                if hi > lo:
                    clipped.append((lo, hi))
        return clipped

    @property
    def busy_s(self):
        return sum(end - start for start, end in self.busy())

    def gaps(self):
        "The device's idle intervals inside the windows: [(start, end)]."
        busy = self.busy()
        out = []
        for w0, w1 in self.windows:
            t = w0
            for start, end in busy:
                if end <= w0 or start >= w1:
                    continue
                if start > t:
                    out.append((t, start))
                t = max(t, end)
            if w1 > t:
                out.append((t, w1))
        return out

    def host_span_at(self, t):
        "The innermost span of the harness that holds the time t."
        holding = [(end - start, name) for name, start, end in self.spans
                   if start <= t < end]
        return min(holding)[1] if holding else "between spans"

    def device_ops(self, top=10, width=160):
        """[[name, seconds]] of the device operations that took most time,
        each name cut to its first ``width`` characters (a template's
        arguments run to thousands)."""
        total = {}
        for name, start, end in self.device:
            total[name] = total.get(name, 0.0) + (end - start)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:width], seconds] for name, seconds in ranked]

    def idle_gaps(self, top=10):
        """[[span, seconds]]: the device's idle time summed by the span the
        host was in halfway through each gap, the largest first."""
        total = {}
        for start, end in self.gaps():
            name = self.host_span_at(0.5 * (start + end))
            total[name] = total.get(name, 0.0) + (end - start)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name, seconds] for name, seconds in ranked]


def _within(t, windows):
    return any(start <= t < end for start, end in windows)


def read_profile(prof):
    """The events of a finished ``torch.profiler.profile`` as
    ``(name, is_device, start_us, end_us)`` tuples."""
    from torch.autograd import DeviceType
    return [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
             e.time_range.end) for e in prof.events()]
