"""gb_prior_roofline: the Gauss-Bernoulli prior kernel's byte bound over its
device time, in %. The kernel (the port's csrc/gb_prior.cu, posterior or
message) reads the lanes' N-element interface once and writes one array of
its size, and reads and writes a few numbers per lane: for each of its
launches in the traced window the bound is
(2 lanes N + 4 lanes) itemsize / ``counts.HBM_BYTES_PER_S``, with the
configuration's N and precision and the traced calls' lanes (frozen lanes
included: they are computed). The metric is the sum of those bounds over
the launches' summed device time from torch.profiler; nothing where no
kernel of that name ran (a program without it)."""
from portbench.counts import HBM_BYTES_PER_S

#: a part of the name of both of the kernel's entry points
#: (gb_prior_posterior_kernel, gb_prior_message_kernel)
NAME = "gb_prior_"
ITEMSIZE = {"float32": 4, "float64": 8}


def bound_s(lanes, n, itemsize):
    """Seconds one launch takes at the card's memory bandwidth: the lanes'
    n elements read and written once, four numbers per lane besides."""
    return (2 * lanes * n + 4 * lanes) * itemsize / HBM_BYTES_PER_S


def read(run):
    if run.timeline is None:
        return None
    events = [end - start for name, start, end in run.timeline.kernels()
              if NAME in name.lower()]
    if not events:
        run.note("gb_prior_roofline: no gb_prior kernel in the trace")
        return None
    bound = bound_s(run.traced_calls[0]["lanes"], run.config["N"],
                    ITEMSIZE[run.config["dtype"]])
    return 100.0 * len(events) * bound / sum(events)
