"""relu_se_mfu: the operations of the SE sweeps the points needed (the sum
of their n_iter times a point's sweep, frozen in the configuration's
``lane_iteration_flops``: the relu channel's two posterior launches and
the eager rest), over the unprofiled calls' wall time times the float64
peak of the FMA units, in %: the relu SE cell's share of the whole step's
peak, read as ``se_grid_mfu`` reads the compressed-sensing grid's."""
from portbench.metrics.se_grid_mfu import read  # noqa: F401
