"""Likelihood base class (EP part). Counterpart of
tramp_tpu/likelihoods/base_likelihood.py:7-28."""
from ..base import Factor, compute_ab_new


class Likelihood(Factor):
    n_next = 0
    n_prev = 1
    isotropic = True

    def compute_backward_message(self, az, bz):
        rz, vz = self.compute_backward_posterior(az, bz, self.y)
        return compute_ab_new(rz, vz, az, bz)
