"""Likelihoods of the EP slice."""
from .base_likelihood import Likelihood
from .gaussian_likelihood import GaussianLikelihood

__all__ = ["Likelihood", "GaussianLikelihood"]
