"""Priors. The registry mirrors tramp_tpu/priors/__init__.py ("positive"
maps to ExponentialPrior, as in the reference)."""
from .base_prior import Prior
from .gaussian_prior import GaussianPrior
from .gauss_bernoulli_prior import GaussBernoulliPrior
from .binary_prior import BinaryPrior
from .gaussian_mixture_prior import GaussianMixturePrior
from .exponential_prior import ExponentialPrior
from .positive_prior import PositivePrior
from .map_priors import MAP_L1NormPrior, MAP_L21NormPrior
from .committee_binary_prior import CommitteeBinaryPrior

PRIOR_CLASSES = {
    "gaussian": GaussianPrior,
    "gauss_bernoulli": GaussBernoulliPrior,
    "binary": BinaryPrior,
    "L1_norm": MAP_L1NormPrior,
    "L21_norm": MAP_L21NormPrior,
    "exponential": ExponentialPrior,
    "positive": ExponentialPrior,
    "mixture": GaussianMixturePrior,
    "committee_binary": CommitteeBinaryPrior,
}


def get_prior(size, prior_type, **kwargs):
    return PRIOR_CLASSES[prior_type](size=size, **kwargs)


__all__ = [
    "Prior", "GaussianPrior", "GaussBernoulliPrior", "BinaryPrior",
    "GaussianMixturePrior", "ExponentialPrior", "PositivePrior",
    "MAP_L1NormPrior", "MAP_L21NormPrior", "CommitteeBinaryPrior",
    "PRIOR_CLASSES", "get_prior",
]
