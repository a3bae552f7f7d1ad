"""iters_per_instance: the mean of the per-instance n_iter that solve_info
returns, over every instance of the window."""


def read(run):
    lanes = sum(c["lanes"] for c in run.calls)
    return sum(c["n_iter_sum"] for c in run.calls) / lanes if lanes else None
