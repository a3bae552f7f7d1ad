"""Special functions, truncated-normal moments, linear regions and the
quadrature of the state evolution."""
from . import special, truncated_normal, integration, linear_region

__all__ = ["special", "truncated_normal", "integration", "linear_region"]
