"""gemm_roofline: the dense products' FLOPs of the traced calls, counted
from the configuration's shapes for the lanes as called (frozen lanes
included: they are computed), over the peak of a product in the
configuration's precision (``counts.PRODUCT_PEAK_FLOPS``), over the device
time of the product kernels (``kernel_names.json``'s "dense_products"), in
%."""
from portbench.counts import PRODUCT_PEAK_FLOPS


def read(run):
    if run.timeline is None:
        return None
    names = run.kernel_names["dense_products"]
    seconds = sum(end - start for name, start, end in run.timeline.kernels()
                  if any(n in name.lower() for n in names))
    if seconds <= 0:
        return None
    flops = sum(run.config_module.call_flops(run.config, c["lanes"],
                                             c["iterations"])
                for c in run.traced_calls)
    peak = PRODUCT_PEAK_FLOPS[run.config["dtype"]]
    return 100.0 * flops / (peak * seconds)
