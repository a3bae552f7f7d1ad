"""Stopping rules of the EP loop. Counterpart of tramp_tpu/algos/callbacks.py
(EarlyStopping / EarlyStoppingEP), which the engine's ``iterate`` reads as
stop parameters (``early_stop=``), as the JAX package's fused loop does."""


class EarlyStopping:
    """Stop when the posterior variances change by less than ``tol``; roll
    back and stop when one grows by more than ``max_increase`` after
    ``wait_increase`` iterations. Reference callbacks.py:195-243."""

    kind = "v"

    def __init__(self, tol=1e-6, wait_increase=5, max_increase=0.2):
        self.tol = tol
        self.wait_increase = wait_increase
        self.max_increase = max_increase


class EarlyStoppingEP(EarlyStopping):
    """The same on the relative change of the posterior means.
    Reference callbacks.py:250-286."""

    kind = "r"
