"""The reference's correctness methodology as a library surface: moments
are gradients of log-partitions (``torch.autograd``), potentials meet their
limits, instances concentrate on their ensembles. Counterpart of
tramp_tpu/checks."""
from .check_gradients import (
    numerical_1st_derivative, numerical_2nd_derivative,
    check_belief_grad_b, plot_belief_grad_b,
    check_prior_grad_EP, check_prior_grad_BO, check_prior_grad_BO_BN,
    check_prior_grad_FG, check_prior_grad_RS,
    check_likelihood_grad_EP, check_likelihood_grad_BO,
    check_likelihood_grad_BO_BN, check_likelihood_grad_RS,
    check_likelihood_grad_FG,
    plot_prior_grad_EP, plot_prior_grad_BO, plot_prior_grad_BO_BN,
    plot_prior_grad_FG, plot_prior_grad_RS,
    plot_likelihood_grad_EP, plot_likelihood_grad_BO,
    plot_likelihood_grad_BO_BN, plot_likelihood_grad_RS,
    plot_likelihood_grad_FG,
    check_prior_grad_EP_scalar, check_prior_grad_EP_diagonal,
    plot_prior_grad_EP_scalar, plot_prior_grad_EP_diagonal,
    check_likelihood_grad_EP_scalar, check_likelihood_grad_EP_diagonal,
    plot_likelihood_grad_EP_scalar, plot_likelihood_grad_EP_diagonal,
)
from .check_limits import (
    check_prior_BO_limit, check_likelihood_BO_limit,
    check_prior_BN_limit, check_likelihood_BN_limit,
    plot_prior_BO_limit, plot_likelihood_BO_limit,
    plot_prior_BN_limit, plot_likelihood_BN_limit,
)
from .check_high_dim import (
    check_prior_concentration,
    check_prior_BO_BN_high_dim, plot_prior_BO_BN_high_dim,
    check_likelihood_BO_BN_high_dim, plot_likelihood_BO_BN_high_dim,
    check_prior_RS_BN_high_dim, plot_prior_RS_BN_high_dim,
    check_likelihood_RS_BN_high_dim, plot_likelihood_RS_BN_high_dim,
)

__all__ = [
    "numerical_1st_derivative", "numerical_2nd_derivative",
    "check_belief_grad_b", "plot_belief_grad_b",
    "check_prior_grad_EP", "check_prior_grad_BO", "check_prior_grad_BO_BN",
    "check_prior_grad_FG", "check_prior_grad_RS",
    "check_likelihood_grad_EP", "check_likelihood_grad_BO",
    "check_likelihood_grad_BO_BN", "check_likelihood_grad_RS",
    "check_likelihood_grad_FG",
    "plot_prior_grad_EP", "plot_prior_grad_BO", "plot_prior_grad_BO_BN",
    "plot_prior_grad_FG", "plot_prior_grad_RS",
    "plot_likelihood_grad_EP", "plot_likelihood_grad_BO",
    "plot_likelihood_grad_BO_BN", "plot_likelihood_grad_RS",
    "plot_likelihood_grad_FG",
    "check_prior_grad_EP_scalar", "check_prior_grad_EP_diagonal",
    "plot_prior_grad_EP_scalar", "plot_prior_grad_EP_diagonal",
    "check_likelihood_grad_EP_scalar", "check_likelihood_grad_EP_diagonal",
    "plot_likelihood_grad_EP_scalar", "plot_likelihood_grad_EP_diagonal",
    "check_prior_BO_limit", "check_likelihood_BO_limit",
    "check_prior_BN_limit", "check_likelihood_BN_limit",
    "plot_prior_BO_limit", "plot_likelihood_BO_limit",
    "plot_prior_BN_limit", "plot_likelihood_BN_limit",
    "check_prior_concentration",
    "check_prior_BO_BN_high_dim", "plot_prior_BO_BN_high_dim",
    "check_likelihood_BO_BN_high_dim", "plot_likelihood_BO_BN_high_dim",
    "check_prior_RS_BN_high_dim", "plot_prior_RS_BN_high_dim",
    "check_likelihood_RS_BN_high_dim", "plot_likelihood_RS_BN_high_dim",
]
