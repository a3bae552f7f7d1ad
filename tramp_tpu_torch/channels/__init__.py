"""Channels. The registry mirrors tramp_tpu/channels/__init__.py: every
type of the JAX package's."""
from .base_channel import Channel, SIFactor, SOFactor, MatrixFactorization
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
from .conv_channel import (
    ConvChannel, DifferentialChannel, LaplacianChannel, Blur1DChannel,
    Blur2DChannel,
)
from .gradient_channel import GradientChannel
from .dft_channel import DFTChannel
from .rotation_channel import RotationChannel
from .activation_channel import ActivationChannel, TanhChannel
from .low_rank import (
    LowRankGramChannel, LowRankFactorization, vamp_matrix_factorization,
    se_matrix_factorization,
)

CHANNEL_CLASSES = {
    "gaussian": GaussianChannel,
    "linear": LinearChannel,
    "complex_linear": ComplexLinearChannel,
    "marchenko": MarchenkoPasturChannel,
    "analytical": AnalyticalLinearChannel,
    "conv": ConvChannel,
    "blur_1d": Blur1DChannel,
    "blur_2d": Blur2DChannel,
    "differential": DifferentialChannel,
    "laplacian": LaplacianChannel,
    "gradient": GradientChannel,
    "dft": DFTChannel,
    "rotation": RotationChannel,
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
    "tanh": TanhChannel,
    "low_rank_gram": LowRankGramChannel,
    "low_rank_factorization": LowRankFactorization,
}


def get_channel(channel_type, **kwargs):
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
    "ConcatChannel", "ReshapeChannel", "MatrixFactorization",
    "ConvChannel", "DifferentialChannel", "LaplacianChannel",
    "Blur1DChannel", "Blur2DChannel", "GradientChannel", "DFTChannel",
    "RotationChannel", "ActivationChannel", "TanhChannel",
    "LowRankGramChannel", "LowRankFactorization",
    "vamp_matrix_factorization", "se_matrix_factorization",
]
