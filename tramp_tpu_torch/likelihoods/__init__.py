"""Likelihoods. The registry mirrors tramp_tpu/likelihoods/__init__.py for
the ported types."""
from .base_likelihood import Likelihood
from .gaussian_likelihood import GaussianLikelihood

LIKELIHOOD_CLASSES = {
    "gaussian": GaussianLikelihood,
}
#: likelihood types of the JAX package that are not ported yet
_WAITING = ("abs", "sgn", "door", "relu", "l-relu", "h-tanh", "h-sigm",
            "a-abs", "modulus")


def get_likelihood(y, likelihood_type, **kwargs):
    if likelihood_type in _WAITING:
        raise NotImplementedError(
            f"likelihood {likelihood_type!r} is not ported yet (ROADMAP "
            "Queue 1 item 3)")
    return LIKELIHOOD_CLASSES[likelihood_type](y=y, **kwargs)


__all__ = ["Likelihood", "GaussianLikelihood", "LIKELIHOOD_CLASSES",
           "get_likelihood"]
