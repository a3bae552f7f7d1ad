"""solve_ms_p95: the 95th percentile of every call's time from the solve
call to the synchronised read of its answers (numpy's linear
interpolation), in ms; the sample count goes to standard error."""
import numpy as np


def read(run):
    times = [1e3 * c["seconds"] for c in run.calls]
    if not times:
        return None
    run.note(f"solve_ms_p95: {len(times)} calls, median "
             f"{float(np.percentile(times, 50))!r} ms")
    return float(np.percentile(times, 95))
