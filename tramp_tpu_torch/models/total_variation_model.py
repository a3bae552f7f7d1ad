"""Sparse-gradient and total-variation model builders. Counterpart of
tramp_tpu/models/total_variation_model.py.

x has a Gaussian prior and its gradient x' = grad x a sparse
(Gauss-Bernoulli) or MAP L21 (TV) prior: a SIMO variable x feeds the
gradient branch, merged at the multi-input leaf x', and the flattened x
the regression or classification block. ``device`` and ``dtype`` are
those of the model's arrays (None: the first card, the default dtype)."""
import numpy as np

from ..variables import SISOVariable as V, SIMOVariable, MILeafVariable
from ..channels import (
    LinearChannel, GaussianChannel, GradientChannel, ReshapeChannel)
from ..priors import GaussianPrior, GaussBernoulliPrior, MAP_L21NormPrior
from ..likelihoods import GaussianLikelihood, SgnLikelihood


def _gradient_block(x_shape, prior_var, grad_prior, device, dtype):
    N = int(np.prod(x_shape))
    return (
        GaussianPrior(size=x_shape, var=prior_var, device=device,
                      dtype=dtype) @
        SIMOVariable(id="x", n_next=2) @ ((
            GradientChannel(shape=x_shape, device=device, dtype=dtype) +
            grad_prior
        ) @ MILeafVariable(id="x'", n_prev=2))
    ) @ ReshapeChannel(prev_shape=x_shape, next_shape=N)


def sparse_gradient_block(x_shape, prior_var, grad_rho, device=None,
                          dtype=None):
    "x with a Gaussian prior whose gradient is Gauss-Bernoulli. Ref l:10-24."
    grad_shape = (len(x_shape),) + tuple(x_shape)
    return _gradient_block(
        x_shape, prior_var,
        GaussBernoulliPrior(size=grad_shape, rho=grad_rho, device=device,
                            dtype=dtype), device, dtype)


def tv_block(x_shape, prior_var, grad_scale, device=None, dtype=None):
    "x with a Gaussian prior whose gradient is MAP L21. Reference l:27-37."
    grad_shape = (len(x_shape),) + tuple(x_shape)
    return _gradient_block(
        x_shape, prior_var,
        MAP_L21NormPrior(size=grad_shape, gamma=grad_scale, axis=0,
                         device=device, dtype=dtype), device, dtype)


def regression_block(A, y, noise_var, device=None, dtype=None):
    return (LinearChannel(A, name="A", device=device, dtype=dtype)
            @ V(id="z")
            @ GaussianLikelihood(y, var=noise_var, device=device,
                                 dtype=dtype))


def classification_block(A, y, noise_var, device=None, dtype=None):
    return (LinearChannel(A, name="A", device=device, dtype=dtype)
            @ V(id="z") @ GaussianChannel(var=noise_var) @ V(id="a")
            @ SgnLikelihood(y, device=device, dtype=dtype))


def sparse_gradient_regression(A, y, x_shape, grad_rho, noise_var, prior_var,
                               device=None, dtype=None):
    block = sparse_gradient_block(x_shape, prior_var, grad_rho, device, dtype)
    return (block @ V(id="r")
            @ regression_block(A, y, noise_var, device, dtype)).to_model()


def sparse_gradient_classification(A, y, x_shape, grad_rho, noise_var,
                                   prior_var, device=None, dtype=None):
    block = sparse_gradient_block(x_shape, prior_var, grad_rho, device, dtype)
    return (block @ V(id="r")
            @ classification_block(A, y, noise_var, device,
                                   dtype)).to_model()


def tv_regression(A, y, x_shape, grad_scale, noise_var, prior_var,
                  device=None, dtype=None):
    block = tv_block(x_shape, prior_var, grad_scale, device, dtype)
    return (block @ V(id="r")
            @ regression_block(A, y, noise_var, device, dtype)).to_model()


def tv_classification(A, y, x_shape, grad_scale, noise_var, prior_var,
                      device=None, dtype=None):
    block = tv_block(x_shape, prior_var, grad_scale, device, dtype)
    return (block @ V(id="r")
            @ classification_block(A, y, noise_var, device,
                                   dtype)).to_model()
