"""Channel base class (EP part). Counterpart of
tramp_tpu/channels/base_channel.py:7-17."""
from ..base import Factor, compute_ab_new


class Channel(Factor):
    n_next = 1
    n_prev = 1

    def compute_forward_message(self, az, bz, ax, bx):
        rx, vx = self.compute_forward_posterior(az, bz, ax, bx)
        return compute_ab_new(rx, vx, ax, bx)

    def compute_backward_message(self, az, bz, ax, bx):
        rz, vz = self.compute_backward_posterior(az, bz, ax, bx)
        return compute_ab_new(rz, vz, az, bz)
