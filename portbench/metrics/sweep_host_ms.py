"""sweep_host_ms: the mean host time of one ``sweep`` span of the port
(``tramp_tpu_torch.trace``) over the traced calls, in ms: the host's time
to enqueue one iteration of the solver loop."""
from portbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "sweep")
