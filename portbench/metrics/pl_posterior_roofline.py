"""pl_posterior_roofline: the five-output posterior kernel's bound, from
the frozen counts (``counts.bound_ms`` of ``pl_posterior`` on the relu
channel's regions) for the shape each launch was given (the traced calls'
lanes of the configuration's ``nodes``, the SE measure's nodes a point),
times the launches the port counted in the traced calls
(``pl_posterior.launches``, advanced on every graph replay), over the
summed device time of the kernels named ``pl_posterior_kernel`` in the
trace, in %. Nothing is read where no such kernel ran or where the traced
and the counted launches differ."""
from portbench.counts import RELU_SPECS, bound_ms

#: a part of the kernel's name (csrc/pl_posterior.cu)
NAME = "pl_posterior_kernel"


def read(run):
    if run.timeline is None or "nodes" not in run.config:
        return None
    events = [end - start for name, start, end in run.timeline.kernels()
              if NAME in name.lower()]
    launches = run.launches.get("pl_posterior", 0)
    if not events or len(events) != launches:
        run.note(f"pl_posterior_roofline: {len(events)} kernels in the "
                 f"trace, {launches} launches counted")
        return None
    bound_s = 1e-3 * launches * bound_ms(
        "pl_posterior", RELU_SPECS, run.config["nodes"], run.config["dtype"],
        lanes=run.traced_calls[0]["lanes"])[0]
    return 100.0 * bound_s / sum(events)
