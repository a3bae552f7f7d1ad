"""pl_message_roofline: the two message kernels' bound, from the frozen
counts (``counts.bound_ms``) for the shapes each launch was given (the
cell's lanes of the relu factor's M elements), summed over the launches the
port counted in the traced calls, over their device time from
torch.profiler (``kernel_names.json``'s "pl_message"), in %."""
from portbench.counts import bound_ms


def read(run):
    shape = run.config_module.messages(run.config)
    if run.timeline is None or shape is None:
        return None
    n, specs = shape
    names = run.kernel_names["pl_message"]
    events = [(end - start) for name, start, end in run.timeline.kernels()
              if any(p in name.lower() for p in names)]
    launches = (run.launches.get("pl_forward_message", 0)
                + run.launches.get("pl_backward_message", 0))
    if not events or len(events) != launches:
        run.note(f"pl_message_roofline: {len(events)} kernels in the trace, "
                 f"{launches} launches counted")
        return None
    lanes = run.traced_calls[0]["lanes"]
    bound_s = 1e-3 * sum(
        run.launches[k] * bound_ms(k, specs, n, run.config["dtype"],
                                   lanes=lanes)[0]
        for k in ("pl_forward_message", "pl_backward_message"))
    return 100.0 * bound_s / sum(events)
