"""device_idle_share: 1 - the union of the device's intervals over the
traced calls' program windows (solve and readout), in %."""


def read(run):
    if run.timeline is None or not run.timeline.device:
        return None
    return 100.0 * (1.0 - run.timeline.busy_s / run.timeline.window_s)
