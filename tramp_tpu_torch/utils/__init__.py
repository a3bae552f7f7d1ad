"""Special functions, truncated-normal moments and linear regions."""
from . import special, truncated_normal, linear_region

__all__ = ["special", "truncated_normal", "linear_region"]
