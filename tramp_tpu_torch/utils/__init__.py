"""Special functions, truncated-normal moments, linear regions, the
quadrature of the state evolution and small array helpers, as modules and,
as in tramp_tpu.utils, by name."""
from . import special, truncated_normal, integration, linear_region, misc
from .special import (
    erfcx, norm_cdf, norm_pdf, log_Phi, log_norm_cdf_prime,
    phi_0, phi_1, phi_2,
)
from .truncated_normal import (
    truncated_normal_mean, truncated_normal_var, truncated_normal_logZ,
    truncated_normal_proba, truncated_normal_log_proba,
)
from .integration import (
    gauss_hermite, gauss_legendre, gaussian_measure, gaussian_measure_2d,
    gaussian_measure_2d_full, truncated_gaussian_measure, exponential_measure,
)
from .misc import (
    complex2array, array2complex, relu, leaky_relu, hard_tanh, hard_sigm,
    symm_door,
)

__all__ = [
    "special", "truncated_normal", "integration", "linear_region", "misc",
    "erfcx", "norm_cdf", "norm_pdf", "log_Phi", "log_norm_cdf_prime",
    "phi_0", "phi_1", "phi_2", "truncated_normal_mean",
    "truncated_normal_var", "truncated_normal_logZ",
    "truncated_normal_proba", "truncated_normal_log_proba", "gauss_hermite",
    "gauss_legendre", "gaussian_measure", "gaussian_measure_2d",
    "gaussian_measure_2d_full", "truncated_gaussian_measure",
    "exponential_measure", "complex2array", "array2complex", "relu",
    "leaky_relu", "hard_tanh", "hard_sigm", "symm_door",
]
