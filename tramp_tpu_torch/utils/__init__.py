"""Special functions, truncated-normal moments, linear regions, the
quadrature of the state evolution and small array helpers."""
from . import special, truncated_normal, integration, linear_region, misc

__all__ = ["special", "truncated_normal", "integration", "linear_region",
           "misc"]
