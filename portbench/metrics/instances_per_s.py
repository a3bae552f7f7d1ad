"""instances_per_s: instances solved to the solver's stop rule (converged,
with finite posteriors) over the whole window, on the host's clock."""


def read(run):
    return sum(c["solved"] for c in run.calls) / run.window_s
