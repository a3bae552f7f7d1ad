"""launches_per_iter: device kernels (copies and sets left out) inside the
program's windows of the traced calls, from torch.profiler, per loop
iteration of those calls."""


def read(run):
    if run.timeline is None or not run.timeline.device:
        return None
    iterations = sum(c["iterations"] for c in run.traced_calls)
    return len(run.timeline.kernels()) / iterations
