"""Structural channels: bias, sum, duplicate, concat, reshape. Counterpart
of tramp_tpu/channels/shape_channels.py.

Sum, duplicate and concat have several inputs or outputs: their messages
are lists, one entry per edge in the model's edge order. With lanes
(tramp_tpu_torch/lanes.py) every entry carries the lane axis first, a
message ``(B,) + shape`` with its precision ``(B, 1, ...)``; the precision
tells whether there are lanes, so a concatenation or a reshape acts on the
axes after the lane axis."""
import math

import torch

from .base_channel import Channel, SIFactor, SOFactor
from ..config import as_tensor
from ..lanes import lane_count, per_lane


def _total(x, a):
    "Sum over the variable's elements: 0-d, or one value per lane ``(B,)``."
    if lane_count(a, x) is not None:
        return per_lane(x, True).sum(-1)
    return torch.sum(x)


def _gaussian_log_partition(a, b):
    "sum of 0.5 (b^2 / a + log(2 pi / a)) over the variable's elements."
    return _total(0.5 * (b**2 / a + torch.log(2 * math.pi / a)), a)


class BiasChannel(Channel):
    """x = z + bias. Reference bias_channel.py:5-53. ``bias`` is a buffer
    (one per lane with lanes)."""

    _data_fields = ("bias",)
    _meta_fields = ()

    def __init__(self, bias, device=None, dtype=None):
        super().__init__()
        self.register_buffer("bias", as_tensor(bias, device, dtype))

    def math(self):
        return r"$+$"

    def sample(self, generator, Z):
        return Z + self.bias

    def second_moment(self, tau_z):
        return tau_z + torch.mean(self.bias**2)

    def compute_forward_message(self, az, bz, ax, bx):
        return az, bz + az * self.bias

    def compute_backward_message(self, az, bz, ax, bx):
        return ax, bx - ax * self.bias

    def compute_forward_state_evolution(self, az, ax, tau_z):
        return az

    def compute_backward_state_evolution(self, az, ax, tau_z):
        return ax

    def compute_log_partition(self, az, bz, ax, bx):
        b = bx + bz - ax * self.bias
        a = ax + az
        return _total(0.5 * (b**2 / a + torch.log(2 * math.pi / a)
                             + 2 * bx * self.bias - ax * self.bias**2), az)

    def compute_mutual_information(self, az, ax, tau_z):
        return 0.5 * torch.log((ax + az) * tau_z)

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + ax * tau_x) - I
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))


class SumChannel(SOFactor):
    "x = sum_k z_k. Reference sum_channel.py:5-59."

    _data_fields = ()
    _meta_fields = ("n_prev",)

    def __init__(self, n_prev):
        super().__init__()
        self.n_prev = n_prev

    def math(self):
        return r"$\Sigma$"

    def sample(self, generator, *Zs):
        return sum(Zs)

    def second_moment(self, *tau_zs):
        return sum(tau_zs)

    @staticmethod
    def _cavity(az, bz):
        "(v_bar, r_bar): the variance and mean of the sum under the z's."
        v_bar = sum(1.0 / a for a in az)
        r_bar = sum(b / a for a, b in zip(az, bz))
        return v_bar, r_bar

    def compute_forward_message(self, az, bz, ax, bx):
        v_bar, r_bar = self._cavity(az, bz)
        return 1.0 / v_bar, r_bar / v_bar

    def compute_backward_message(self, az, bz, ax, bx):
        v_bar, r_bar = self._cavity(az, bz)
        vx, rx = 1.0 / ax, bx / ax
        vk = [vx + v_bar - 1.0 / a for a in az]
        rk = [rx - r_bar + b / a for a, b in zip(az, bz)]
        return [1.0 / v for v in vk], [r / v for v, r in zip(vk, rk)]

    def compute_forward_state_evolution(self, az, ax, tau_z):
        return 1.0 / sum(1.0 / a for a in az)

    def compute_backward_state_evolution(self, az, ax, tau_z):
        v_bar = sum(1.0 / a for a in az)
        return [1.0 / (1.0 / ax + v_bar - 1.0 / a) for a in az]

    def compute_log_partition(self, az, bz, ax, bx):
        # Gaussian integral of prod_k N(z_k; b_k/a_k, 1/a_k) delta(x - sum z)
        v_bar, r_bar = self._cavity(az, bz)
        a_sum = 1.0 / v_bar
        a = a_sum + ax
        b = a_sum * r_bar + bx
        logZ_z = sum(_gaussian_log_partition(ak, bk)
                     for ak, bk in zip(az, bz))
        return logZ_z + _total(0.5 * (b**2 / a - a_sum * r_bar**2
                                      + torch.log(a_sum / a)), ax)


class DuplicateChannel(SIFactor):
    "x_k = z for all k. Reference duplicate_channel.py:4-51."

    _data_fields = ()
    _meta_fields = ("n_next",)

    def __init__(self, n_next):
        super().__init__()
        self.n_next = n_next

    def math(self):
        return r"$\delta$"

    def out_shape(self, shape):
        return [tuple(shape)] * self.n_next

    def sample(self, generator, Z):
        return (Z,) * self.n_next

    def second_moment(self, tau_z):
        return (tau_z,) * self.n_next

    def compute_forward_posterior(self, az, bz, ax, bx):
        rz, vz = self.compute_backward_posterior(az, bz, ax, bx)
        return [rz] * self.n_next, [vz] * self.n_next

    def compute_backward_posterior(self, az, bz, ax, bx):
        a = az + sum(ax)
        b = bz + sum(bx)
        return b / a, 1.0 / a

    def compute_forward_error(self, az, ax, tau_z):
        return [self.compute_backward_error(az, ax, tau_z)] * self.n_next

    def compute_backward_error(self, az, ax, tau_z):
        return 1.0 / (az + sum(ax))

    def compute_log_partition(self, az, bz, ax, bx):
        return _gaussian_log_partition(az + sum(ax), bz + sum(bx))


class ConcatChannel(SOFactor):
    """x = concat(z_1..z_K) along ``axis`` of the variables (the axis after
    the lane axis with lanes). Reference concat_channel.py:5-84."""

    _data_fields = ()
    _meta_fields = ("Ns", "axis", "n_prev", "N")

    def __init__(self, Ns, axis=0):
        super().__init__()
        self.Ns = tuple(Ns)
        self.axis = axis
        self.n_prev = len(Ns)
        self.N = sum(Ns)

    def math(self):
        return r"$\oplus$"

    def _dim(self, a, b):
        "The tensor axis of the concatenation for a message b with precision a."
        if self.axis >= 0 and lane_count(a, b) is not None:
            return self.axis + 1
        return self.axis

    def out_shape(self, *shapes):
        shape = list(shapes[0])
        shape[self.axis] = sum(s[self.axis] for s in shapes)
        return tuple(shape)

    def sample(self, generator, *Zs):
        return torch.cat(Zs, dim=self.axis)

    def second_moment(self, *tau_zs):
        return sum(N * t for N, t in zip(self.Ns, tau_zs)) / self.N

    def _split(self, ax, bx):
        return torch.split(bx, list(self.Ns), dim=self._dim(ax, bx))

    def compute_forward_posterior(self, az, bz, ax, bx):
        rz, vz = self.compute_backward_posterior(az, bz, ax, bx)
        rx = torch.cat(rz, dim=self._dim(ax, bx))
        vx = sum(N * v for N, v in zip(self.Ns, vz)) / self.N
        return rx, vx

    def compute_backward_posterior(self, az, bz, ax, bx):
        ak = [a + ax for a in az]
        bk = [b + s for b, s in zip(bz, self._split(ax, bx))]
        return [b / a for a, b in zip(ak, bk)], [1.0 / a for a in ak]

    def compute_forward_error(self, az, ax, tau_z):
        vz = self.compute_backward_error(az, ax, tau_z)
        return sum(N * v for N, v in zip(self.Ns, vz)) / self.N

    def compute_backward_error(self, az, ax, tau_z):
        return [1.0 / (a + ax) for a in az]

    def compute_log_partition(self, az, bz, ax, bx):
        return sum(_gaussian_log_partition(a + ax, b + s)
                   for a, b, s in zip(az, bz, self._split(ax, bx)))


class ReshapeChannel(Channel):
    """Reshape passthrough. Reference reshape_channel.py:4-55. With lanes
    the lane axis stays first: ``(B,) + prev_shape`` becomes
    ``(B,) + next_shape``, and the precision ``(B, 1, ...)`` takes one axis
    of length 1 per axis of the new shape."""

    _data_fields = ()
    _meta_fields = ("prev_shape", "next_shape")

    def __init__(self, prev_shape, next_shape):
        super().__init__()
        self.prev_shape = (prev_shape if isinstance(prev_shape, tuple)
                           else (prev_shape,))
        self.next_shape = (next_shape if isinstance(next_shape, tuple)
                           else (next_shape,))

    def math(self):
        return r"$\delta$"

    def out_shape(self, shape):
        return self.next_shape

    def sample(self, generator, Z):
        return Z.reshape(self.next_shape)

    def second_moment(self, tau_z):
        return tau_z

    @staticmethod
    def _reshape(a, b, shape):
        "(a, b) of a message b with precision a, b reshaped to ``shape``."
        B = lane_count(a, b)
        if B is None:
            return a, b.reshape(shape)
        return (a.reshape((B,) + (1,) * len(shape)),
                b.reshape((B,) + tuple(shape)))

    def compute_forward_message(self, az, bz, ax, bx):
        return self._reshape(az, bz, self.next_shape)

    def compute_backward_message(self, az, bz, ax, bx):
        return self._reshape(ax, bx, self.prev_shape)

    def compute_forward_state_evolution(self, az, ax, tau_z):
        return az

    def compute_backward_state_evolution(self, az, ax, tau_z):
        return ax

    def compute_log_partition(self, az, bz, ax, bx):
        ax, bx = self._reshape(ax, bx, self.prev_shape)
        return _gaussian_log_partition(az + ax, bz + bx)

    def compute_mutual_information(self, az, ax, tau_z):
        return 0.5 * torch.log((ax + az) * tau_z)

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + ax * tau_x) - I
                + 0.5 * torch.log(2 * math.pi * tau_z / math.e))
