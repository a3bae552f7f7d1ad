"""Priors of the EP slice."""
from .base_prior import Prior
from .gauss_bernoulli_prior import GaussBernoulliPrior

__all__ = ["Prior", "GaussBernoulliPrior"]
