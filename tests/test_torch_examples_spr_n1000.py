"""sparse_phase_retrieval's EP protocol at alpha 1.2, N = 1000, 8 seeds as
the lanes of one batched solve, against the JAX package on the same
instances: every seed stops near the symmetric point (the rule and the
tolerances of tests/test_torch_examples_spr.py).
"""
from test_torch_examples_spr import hold_stalled_seeds


def test_every_seed_stalls_at_n1000():
    hold_stalled_seeds(1000, 1.2, 8, 8)
