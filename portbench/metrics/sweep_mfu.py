"""sweep_mfu: the dense-product FLOPs of the lane-iterations the instances
needed (the sum of their n_iter times a lane-iteration's FLOPs), over the
calls' wall time times the peak of the products' precision, in %; over the
calls the profiler did not record, whose time it does not stretch."""
from portbench.counts import PRODUCT_PEAK_FLOPS


def read(run):
    calls = [c for c in run.calls if not c["profiled"]]
    seconds = sum(c["wall"] for c in calls)
    if not calls or seconds <= 0:
        return None
    flops = (run.config_module.lane_iteration_flops(run.config)
             * sum(c["n_iter_sum"] for c in calls))
    peak = PRODUCT_PEAK_FLOPS[run.config["dtype"]]
    return 100.0 * flops / (peak * seconds)
