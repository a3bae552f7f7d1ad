"""Likelihoods. The registry mirrors tramp_tpu/likelihoods/__init__.py."""
from .base_likelihood import Likelihood
from .gaussian_likelihood import GaussianLikelihood
from .sgn_likelihood import SgnLikelihood
from .abs_likelihood import AbsLikelihood
from .modulus_likelihood import ModulusLikelihood
from .piecewise_linear_likelihood import (
    PiecewiseLinearLikelihood, LinearRegionLikelihood,
    ReluLikelihood, LeakyReluLikelihood, AsymmetricAbsLikelihood,
    HardTanhLikelihood, HardSigmoidLikelihood, SymmetricDoorLikelihood,
)

LIKELIHOOD_CLASSES = {
    "gaussian": GaussianLikelihood,
    "abs": AbsLikelihood,
    "sgn": SgnLikelihood,
    "door": SymmetricDoorLikelihood,
    "relu": ReluLikelihood,
    "l-relu": LeakyReluLikelihood,
    "h-tanh": HardTanhLikelihood,
    "h-sigm": HardSigmoidLikelihood,
    "a-abs": AsymmetricAbsLikelihood,
    "modulus": ModulusLikelihood,
}


def get_likelihood(y, likelihood_type, **kwargs):
    return LIKELIHOOD_CLASSES[likelihood_type](y=y, **kwargs)


__all__ = [
    "Likelihood", "GaussianLikelihood", "SgnLikelihood", "AbsLikelihood",
    "ModulusLikelihood", "PiecewiseLinearLikelihood",
    "LinearRegionLikelihood", "ReluLikelihood", "LeakyReluLikelihood",
    "AsymmetricAbsLikelihood", "HardTanhLikelihood", "HardSigmoidLikelihood",
    "SymmetricDoorLikelihood", "LIKELIHOOD_CLASSES", "get_likelihood",
]
