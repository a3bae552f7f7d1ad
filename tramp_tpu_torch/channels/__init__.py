"""Channels. The registry mirrors tramp_tpu/channels/__init__.py for the
ported types."""
from .base_channel import Channel, SIFactor, SOFactor
from .complex_linear_channel import ComplexLinearChannel
from .modulus_channel import ModulusChannel
from .shape_channels import (
    BiasChannel, SumChannel, DuplicateChannel, ConcatChannel, ReshapeChannel)
from .unitary_channel import UnitaryChannel
from .analytical_linear_channel import (
    AnalyticalLinearChannel, MarchenkoPasturChannel)
from .analytic_activations import AnalyticAbsChannel, AnalyticReluChannel
from .gaussian_channel import GaussianChannel
from .linear_channel import LinearChannel
from .piecewise_linear_channel import (
    PiecewiseLinearChannel, SgnChannel, AbsChannel, AsymmetricAbsChannel,
    ReluChannel, LeakyReluChannel, HardTanhChannel, HardSigmoidChannel,
    SymmetricDoorChannel,
)

CHANNEL_CLASSES = {
    "gaussian": GaussianChannel,
    "linear": LinearChannel,
    "complex_linear": ComplexLinearChannel,
    "marchenko": MarchenkoPasturChannel,
    "analytical": AnalyticalLinearChannel,
    "unitary": UnitaryChannel,
    "modulus": ModulusChannel,
    "bias": BiasChannel,
    "sum": SumChannel,
    "duplicate": DuplicateChannel,
    "concat": ConcatChannel,
    "reshape": ReshapeChannel,
    "sgn": SgnChannel,
    "abs": AbsChannel,
    "a-abs": AsymmetricAbsChannel,
    "relu": ReluChannel,
    "l-relu": LeakyReluChannel,
    "h-tanh": HardTanhChannel,
    "h-sigm": HardSigmoidChannel,
    "door": SymmetricDoorChannel,
}
#: channel types of the JAX package that are not ported yet: the structured
#: real channels (ROADMAP Queue 1 item 4c) and the tanh activation (item 7)
_WAITING = ("conv", "blur_1d", "blur_2d", "differential", "laplacian",
            "gradient", "dft", "rotation", "tanh")


def get_channel(channel_type, **kwargs):
    if channel_type in _WAITING:
        raise NotImplementedError(
            f"channel {channel_type!r} is not ported yet (ROADMAP Queue 1 "
            f"item {'7' if channel_type == 'tanh' else '4c'})")
    return CHANNEL_CLASSES[channel_type](**kwargs)


__all__ = [
    "Channel", "SIFactor", "SOFactor", "AnalyticalLinearChannel",
    "MarchenkoPasturChannel", "AnalyticAbsChannel", "AnalyticReluChannel",
    "CHANNEL_CLASSES", "get_channel",
    "GaussianChannel", "LinearChannel", "PiecewiseLinearChannel",
    "SgnChannel", "AbsChannel", "AsymmetricAbsChannel", "ReluChannel",
    "LeakyReluChannel", "HardTanhChannel", "HardSigmoidChannel",
    "SymmetricDoorChannel", "ComplexLinearChannel", "UnitaryChannel",
    "ModulusChannel", "BiasChannel", "SumChannel", "DuplicateChannel",
    "ConcatChannel", "ReshapeChannel",
]
