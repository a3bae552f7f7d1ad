"""Priors. The registry mirrors tramp_tpu/priors/__init__.py for the ported
types."""
from .base_prior import Prior
from .gauss_bernoulli_prior import GaussBernoulliPrior

PRIOR_CLASSES = {
    "gauss_bernoulli": GaussBernoulliPrior,
}
#: prior types of the JAX package that are not ported yet
_WAITING = ("gaussian", "binary", "L1_norm", "L21_norm", "exponential",
            "positive", "mixture", "committee_binary")


def get_prior(size, prior_type, **kwargs):
    if prior_type in _WAITING:
        raise NotImplementedError(
            f"prior {prior_type!r} is not ported yet (ROADMAP Queue 1 "
            "item 3)")
    return PRIOR_CLASSES[prior_type](size=size, **kwargs)


__all__ = ["Prior", "GaussBernoulliPrior", "PRIOR_CLASSES", "get_prior"]
