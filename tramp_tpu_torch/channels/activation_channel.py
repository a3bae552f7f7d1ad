"""Smooth activation channel x = f(z) by fixed-node quadrature.
Counterpart of tramp_tpu/channels/activation_channel.py.

The per-element integral over the tilted belief is a sum over composite
Gauss-Legendre nodes (16 panels of order 12 on bz/az +- 10/sqrt(az)); the
nodes go on a trailing axis, so that the lane axis of a message ``(B, n)``
with precisions ``(B, 1)`` stays first (the modulus channel's layout)."""
import torch

from .base_channel import Channel
from ..lanes import lane_mean
from ..utils.integration import (
    composite_gauss_legendre, gaussian_measure, rule_on)

FUNCTIONS = {"tanh": torch.tanh, "sin": torch.sin, "cos": torch.cos,
             "erf": torch.special.erf}


class ActivationChannel(Channel):
    """x = func(z) with ``func`` one of ``FUNCTIONS`` by name, or a callable
    on tensors. Reference activation_channel.py:15-85."""

    _data_fields = ()
    _meta_fields = ("name",)

    def __init__(self, func, name=None):
        super().__init__()
        if isinstance(func, str):
            name = func
            func = FUNCTIONS[func]
        self.name = name or getattr(func, "__name__", "f")
        self._func = func

    def math(self):
        return rf"$\mathrm{{{self.name}}}$"

    @property
    def func(self):
        func = self.__dict__.get("_func")
        return func if func is not None else FUNCTIONS[self.name]

    def sample(self, generator, Z):
        return self.func(Z)

    def second_moment(self, tau_z):
        # a Python number (a prior's second moment) becomes a float64 scalar
        tau_z = torch.as_tensor(tau_z, dtype=None if isinstance(
            tau_z, torch.Tensor) else torch.float64)
        return gaussian_measure(0.0, torch.sqrt(tau_z),
                                lambda z: self.func(z) ** 2)

    def _moments(self, az, bz, ax, bx):
        """Moments of the tilted belief
        p(z) ~ exp(-az z^2/2 + bz z - ax f(z)^2/2 + bx f(z)) over
        z in bz/az +- 10/sqrt(az) (reference integration range l:38-40)."""
        u, w = rule_on(bz, composite_gauss_legendre, 0.0, 1.0, 16, 12)
        m = bz / az
        s = 1.0 / torch.sqrt(torch.as_tensor(az, dtype=bz.dtype,
                                             device=bz.device))
        lift = (lambda a: a.unsqueeze(-1)
                if isinstance(a, torch.Tensor) and a.ndim > 0 else a)
        # nodes along a new trailing axis
        z = m[..., None] + lift(s) * (20.0 * u - 10.0)
        x = self.func(z)
        L = (-0.5 * lift(ax) * x**2 + bx[..., None] * x
             - 0.5 * lift(az) * z**2 + bz[..., None] * z)
        L = L - torch.amax(L, dim=-1, keepdim=True)
        p = torch.exp(L) * w
        Z0 = torch.sum(p, dim=-1)
        rz = torch.sum(p * z, dim=-1) / Z0
        z2 = torch.sum(p * z**2, dim=-1) / Z0
        rx = torch.sum(p * x, dim=-1) / Z0
        x2 = torch.sum(p * x**2, dim=-1) / Z0
        return rz, z2 - rz**2, rx, x2 - rx**2

    def compute_forward_posterior(self, az, bz, ax, bx):
        _, _, rx, vx = self._moments(az, bz, ax, bx)
        return rx, lane_mean(vx, ax)

    def compute_backward_posterior(self, az, bz, ax, bx):
        rz, vz, _, _ = self._moments(az, bz, ax, bx)
        return rz, lane_mean(vz, az)

    # elementwise SE integrands (no isotropic reduce; see base_channel.py)
    def scalar_forward_variance(self, az, bz, ax, bx):
        return self._moments(az, bz, ax, bx)[3]

    def scalar_backward_variance(self, az, bz, ax, bx):
        return self._moments(az, bz, ax, bx)[1]


class TanhChannel(ActivationChannel):
    def __init__(self):
        super().__init__(func="tanh")
