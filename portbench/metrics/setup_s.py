"""setup_s: from the start of the harness's script to the first timed call:
imports, the CUDA context, the operator, the model (W's SVD), one solve at
the cell's shapes (with the kernels' build in a checkout's first run)."""


def read(run):
    return run.setup_s
