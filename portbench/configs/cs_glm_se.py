"""The compressed-sensing GLM's State Evolution through the port: the model
of one grid point, the grid's axes, and the frozen operation count of one
SE sweep (``configs/cs_glm_se.json`` holds the settings)."""
import numpy as np

#: operations of one SE sweep of one point (``StateEvolution._sweep``),
#: counted once on the CPU from the port as it stood when this cell was
#: added, with a ``TorchDispatchMode`` over a sweep of a small grid: every
#: floating-point elementwise operation one per element of its output
#: (exp, sigmoid, pow, sqrt, log each as one), a sum one per element
#: summed; comparisons, selects, sorts, copies and views none. Nearly all
#: of it is the prior's average, 2 x 640 nodes at 26 operations each
#: (mul 11,542, add 6,418, div 5,139, pow 3,847, sub and rsub 2,603, exp,
#: sigmoid and sum 1,280 each); frozen here so that a change to the
#: program cannot move it.
LANE_ITERATION_FLOPS = 33_435


def point_builder(config):
    """(the port's ``glm_state_evolution``, the keywords every point of
    the grid shares): the builder ``parallel.build_se_grid`` calls once per
    (alpha, prior_rho)."""
    import tramp_tpu_torch as tt
    return tt.glm_state_evolution, dict(
        prior_type="gauss_bernoulli", output_type="gaussian",
        prior_mean=config["prior_mean"], prior_var=config["prior_var"],
        output_var=config["output_var"])


def axis(spec):
    "A grid axis of the configuration: ``linspace(start, stop, num)``."
    return np.linspace(spec["start"], spec["stop"], spec["num"])


def alphas(config, shift):
    """The grid's alphas: the axis moved by ``shift`` (one per alpha), and
    the golden alphas unmoved, sorted."""
    moved = axis(config["alphas"]) + shift
    return np.sort(np.concatenate([moved, config["golden_alphas"]]))


def lane_iteration_flops(config):
    "Operations of one SE sweep of one point (``LANE_ITERATION_FLOPS``)."
    return LANE_ITERATION_FLOPS


def messages(config):
    "The piecewise-linear message kernels' shape per lane: none here."
    return None
