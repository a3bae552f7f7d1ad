"""The relu GLM's State Evolution through the port: the model of one grid
point, the grid's axes, and the frozen operation count of one SE sweep
(``configs/relu_se.json`` holds the settings)."""
import numpy as np

from .. import counts

#: operations of one SE sweep of one point (``StateEvolution._sweep``)
#: outside the relu channel's posterior, counted once on the CPU from the
#: port as it stood when this cell was added, with a ``TorchDispatchMode``
#: over a sweep of a small grid and the plain posterior left out (the card
#: runs the ``pl_posterior`` kernel there): every floating-point elementwise
#: operation one per element of its output (exp, erf, sigmoid, pow, sqrt,
#: log each as one), a sum one per element summed; comparisons, selects,
#: copies and views none. Nearly all of it is the relu channel's two
#: measures, 2 x 20,000 nodes (mul 311,586, add 186,432, div 85,141, sub
#: and rsub 122,611, erf 40,000, sum 41,280), and the prior's average, 2 x
#: 640 nodes; frozen here so that a change to the program cannot move it.
EAGER_FLOPS = 793_498


def relu_glm(alpha, prior_rho, prior_mean, prior_var, output_var):
    """The model of one grid point, from the port's public factors."""
    import tramp_tpu_torch as tt
    from tramp_tpu_torch.channels import MarchenkoPasturChannel, ReluChannel
    from tramp_tpu_torch.likelihoods import GaussianLikelihood
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    return (GaussBernoulliPrior(size=1, rho=prior_rho, mean=prior_mean,
                                var=prior_var) @ tt.V(id="x")
            @ MarchenkoPasturChannel(alpha) @ tt.V(id="z") @ ReluChannel()
            @ tt.V(id="a") @ GaussianLikelihood(y=None, var=output_var)
            ).to_model()


def point_builder(config):
    """(``relu_glm``, the keywords every point of the grid shares): the
    builder ``parallel.build_se_grid`` calls once per (alpha, prior_rho)."""
    return relu_glm, dict(prior_mean=config["prior_mean"],
                          prior_var=config["prior_var"],
                          output_var=config["output_var"])


def axis(spec):
    "A grid axis of the configuration: ``linspace(start, stop, num)``."
    return np.linspace(spec["start"], spec["stop"], spec["num"])


def alphas(config, shift):
    "The grid's alphas: the axis moved by ``shift`` (one per alpha)."
    return axis(config["alphas"]) + shift


def lane_iteration_flops(config):
    """Operations of one SE sweep of one point: the two ``pl_posterior``
    launches on the configuration's nodes (``counts.operations``) and
    ``EAGER_FLOPS``."""
    return (2 * counts.operations("pl_posterior", counts.RELU_SPECS,
                                  config["nodes"]) + EAGER_FLOPS)
