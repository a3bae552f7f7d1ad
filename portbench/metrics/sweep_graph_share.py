"""sweep_graph_share: the share of the traced calls' ``sweep`` spans of the
port (``tramp_tpu_torch.trace``) that hold a ``replay`` span, the launch of
one captured CUDA graph of the whole iteration, in %. Nothing is read from
a program that opens no ``replay`` span (``trace.NAMES``): it has no graph
path."""
import bisect

from portbench.program_spans import solves


def read(run):
    spans = solves(run)
    if spans is None:
        return None
    from tramp_tpu_torch import trace
    if "replay" not in getattr(trace, "NAMES", ()):
        run.note("sweep_graph_share: the program opens no replay span")
        return None
    held = total = 0
    for call in spans:
        replays = sorted(r.start_ns for r in call if r.name == "replay")
        for r in call:
            if r.name != "sweep":
                continue
            total += 1
            k = bisect.bisect_left(replays, r.start_ns)
            held += k < len(replays) and replays[k] < r.end_ns
    if not total:
        run.note("sweep_graph_share: no sweep span in the traced calls")
        return None
    return 100.0 * held / total
