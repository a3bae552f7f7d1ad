"""se_grid_mfu: the operations of the SE sweeps the points needed (the sum
of their n_iter times a point's sweep, frozen in the configuration's
``lane_iteration_flops``), over the calls' wall time times the float64
peak of the FMA units (``counts.PEAK_FLOPS``), in %; over the calls the
profiler did not record, whose time it does not stretch. The cell's share
of the whole step's peak."""
from portbench.counts import PEAK_FLOPS


def read(run):
    calls = [c for c in run.calls if not c["profiled"]]
    seconds = sum(c["wall"] for c in calls)
    if not calls or seconds <= 0:
        return None
    flops = (run.config_module.lane_iteration_flops(run.config)
             * sum(c["n_iter_sum"] for c in calls))
    return 100.0 * flops / (PEAK_FLOPS[run.config["dtype"]] * seconds)
