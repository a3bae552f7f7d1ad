"""The low-rank family: the embedded VAMP solver and its channels."""
from .low_rank_channels import LowRankGramChannel, LowRankFactorization
from .vamp_solver import (vamp_matrix_factorization,
                          forward_posterior_from_marginals,
                          se_matrix_factorization,
                          se_matrix_factorization_kk)

__all__ = [
    "LowRankGramChannel", "LowRankFactorization",
    "vamp_matrix_factorization", "forward_posterior_from_marginals",
    "se_matrix_factorization", "se_matrix_factorization_kk",
]
