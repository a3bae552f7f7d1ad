"""Inference engines."""
from .callbacks import EarlyStopping, EarlyStoppingEP
from .expectation_propagation import ExpectationPropagation
from .initial_conditions import ConstantInit

__all__ = ["EarlyStopping", "EarlyStoppingEP", "ExpectationPropagation",
           "ConstantInit"]
