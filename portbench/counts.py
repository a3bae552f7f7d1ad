"""The yardstick's frozen counts: the published peaks of one NVIDIA H100
SXM, the operations and bytes of the piecewise-linear message kernels, and
the roofline bound that follows from them.

The kernel counts are a copy of chip_smoke.py's ``REGION_OPS``,
``ELEMENT_OPS``, ``operations`` and ``bound_ms``, counted from
tramp_tpu_torch/csrc/pl_common.cuh; they live here so that a change to the
program cannot move them. The dense products' FLOPs are counted by each
configuration's module from its shapes (``configs/<builder>.py``).
"""
import math

#: NVIDIA's data sheet, H100 SXM, dense rates, at the full 700 W: memory,
#: and the FMA units outside the tensor cores (the elementwise kernels)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 33.5e12}
#: the same sheet's peak of a dense product in each precision as cuBLAS runs
#: it: float32 on the FMA units (TF32 stays off), float64 on the FP64 tensor
#: cores (DMMA, which cuBLAS's DGEMM uses on the H100), bfloat16 on the
#: tensor cores
PRODUCT_PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12}

# Operations per element, counted from csrc/pl_common.cuh. Per region: the
# tilted Gaussian, mean, variance, log-partition and weight (region_moments
# without the G functions), then G0, G1, G2 by the interval's kind (the
# cheaper branch where the data decides), the x-side moments, the softmax
# weight, and one side's share of the merge.
REGION_OPS = {"moments": 28, "both_inf": 0, "half_inf": 13, "finite": 25,
              "x_side": 3, "softmax": 4, "merge_side": 7}
ELEMENT_OPS = {"softmax": 1, "merge_side": 3, "logZ": 2,
               "mean_and_update": 4}

#: tramp_tpu_torch.channels.ReluChannel's regions (zmin, zmax, x0, slope)
RELU_SPECS = ((0.0, math.inf, 0.0, 1.0), (-math.inf, 0.0, 0.0, 0.0))


def operations(kernel, specs, n):
    "Operations of one call on n elements (see REGION_OPS)."
    per_element = 0
    for zmin, zmax, _, _ in specs:
        infinite = (zmin == -math.inf) + (zmax == math.inf)
        kind = ("finite", "half_inf", "both_inf")[infinite]
        per_element += (REGION_OPS["moments"] + REGION_OPS[kind]
                        + REGION_OPS["softmax"])
        if kernel == "pl_posterior":
            per_element += REGION_OPS["x_side"] + 2 * REGION_OPS["merge_side"]
        else:
            per_element += REGION_OPS["merge_side"]
            if kernel == "pl_forward_message":
                per_element += REGION_OPS["x_side"]
    per_element += ELEMENT_OPS["softmax"]
    if kernel == "pl_posterior":
        per_element += 2 * ELEMENT_OPS["merge_side"] + ELEMENT_OPS["logZ"]
    else:
        per_element += (ELEMENT_OPS["merge_side"]
                        + ELEMENT_OPS["mean_and_update"])
    return per_element * n


def bound_ms(kernel, specs, n, dtype, lanes=1):
    """(bound in ms, "bytes" or "operations", bytes moved) for ``lanes``
    lanes of n elements with one precision per lane and side: inputs read
    once (bz, bx, az, ax), outputs written once (five streams, or b_new and
    a_new). ``dtype`` is "float32" or "float64"."""
    itemsize = 4 if dtype == "float32" else 8
    total = lanes * n
    outputs = 5 * total if kernel == "pl_posterior" else total + lanes
    moved = (2 * total + 2 * lanes + outputs) * itemsize
    by_bytes = moved / HBM_BYTES_PER_S
    by_ops = operations(kernel, specs, total) / PEAK_FLOPS[dtype]
    which = "bytes" if by_bytes >= by_ops else "operations"
    return 1e3 * max(by_bytes, by_ops), which, moved
