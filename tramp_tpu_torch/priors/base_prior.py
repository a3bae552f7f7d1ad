"""Prior base class (EP part). Counterpart of
tramp_tpu/priors/base_prior.py:11-19."""
from ..base import Factor, compute_ab_new


class Prior(Factor):
    n_next = 1
    n_prev = 0
    isotropic = True

    def compute_forward_message(self, ax, bx):
        rx, vx = self.compute_forward_posterior(ax, bx)
        return compute_ab_new(rx, vx, ax, bx)
