"""Inference engines, initializers, metrics and callbacks."""
from .message_passing import MessagePassing
from .expectation_propagation import ExpectationPropagation
from .state_evolution import StateEvolution
from .explain import (
    ExplainMessagePassing, ExplainStateEvolution, DisplayLatexMessagePassing,
)
from .initial_conditions import ConstantInit, NoisyInit, CustomInit
from .metrics import (
    METRICS, mean_squared_error, sign_symmetric_mse, phase_symmetric_mse,
    overlap,
)
from .callbacks import (
    Callback, PassCallback, JoinCallback, LogProgress, TrackMessages,
    TrackObjective, TrackEvolution, TrackEstimate, TrackErrors,
    TrackOverlaps, EarlyStopping, EarlyStoppingEP,
)

__all__ = [
    "MessagePassing", "ExpectationPropagation", "StateEvolution",
    "ExplainMessagePassing", "ExplainStateEvolution",
    "DisplayLatexMessagePassing",
    "ConstantInit", "NoisyInit", "CustomInit", "METRICS",
    "mean_squared_error", "sign_symmetric_mse", "phase_symmetric_mse",
    "overlap", "Callback", "PassCallback", "JoinCallback", "LogProgress",
    "TrackMessages", "TrackObjective", "TrackEvolution", "TrackEstimate",
    "TrackErrors", "TrackOverlaps", "EarlyStopping", "EarlyStoppingEP",
]
