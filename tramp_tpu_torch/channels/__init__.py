"""Channels of the EP slice."""
from .base_channel import Channel
from .gaussian_channel import GaussianChannel
from .linear_channel import LinearChannel
from .piecewise_linear_channel import (
    PiecewiseLinearChannel, SgnChannel, AbsChannel, AsymmetricAbsChannel,
    ReluChannel, LeakyReluChannel, HardTanhChannel, HardSigmoidChannel,
    SymmetricDoorChannel,
)

__all__ = [
    "Channel", "GaussianChannel", "LinearChannel", "PiecewiseLinearChannel",
    "SgnChannel", "AbsChannel", "AsymmetricAbsChannel", "ReluChannel",
    "LeakyReluChannel", "HardTanhChannel", "HardSigmoidChannel",
    "SymmetricDoorChannel",
]
