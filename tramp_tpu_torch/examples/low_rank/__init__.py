"""The low-rank matrix-factorization example."""
