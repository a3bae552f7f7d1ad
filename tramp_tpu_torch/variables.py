"""Variable node classes (structural metadata only; cavity-sum math lives in
the engines). Counterpart of tramp_tpu/variables.py."""
from .base import Variable


class SISOVariable(Variable):
    def __init__(self, id):
        super().__init__(id=id, n_prev=1, n_next=1)


class SILeafVariable(Variable):
    def __init__(self, id):
        super().__init__(id=id, n_prev=1, n_next=0)


# short aliases used throughout the examples (reference uses V and O)
V = SISOVariable
O = SILeafVariable
