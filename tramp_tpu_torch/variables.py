"""Variable node classes (structural metadata only; cavity-sum math lives in
the engines). Counterpart of tramp_tpu/variables.py."""
from .base import Variable


class SISOVariable(Variable):
    def __init__(self, id):
        super().__init__(id=id, n_prev=1, n_next=1)


class SIMOVariable(Variable):
    def __init__(self, id, n_next):
        super().__init__(id=id, n_prev=1, n_next=n_next)


class MISOVariable(Variable):
    def __init__(self, id, n_prev):
        super().__init__(id=id, n_prev=n_prev, n_next=1)


class MILeafVariable(Variable):
    def __init__(self, id, n_prev):
        super().__init__(id=id, n_prev=n_prev, n_next=0)


class SILeafVariable(Variable):
    def __init__(self, id):
        super().__init__(id=id, n_prev=1, n_next=0)


class MORootVariable(Variable):
    def __init__(self, id, n_next):
        super().__init__(id=id, n_prev=0, n_next=n_next)


class SORootVariable(Variable):
    def __init__(self, id):
        super().__init__(id=id, n_prev=0, n_next=1)


# short aliases used throughout the examples (reference uses V and O)
V = SISOVariable
O = SILeafVariable
