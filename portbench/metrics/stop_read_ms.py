"""stop_read_ms: the mean host time of one ``stop_read`` span of the port
(``tramp_tpu_torch.trace``) over the traced calls, in ms: how long the
solver loop waits on the device at its one host read."""
from portbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "stop_read")
