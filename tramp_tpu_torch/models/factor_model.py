"""Model from a raw FactorDAG. Counterpart of
tramp_tpu/models/factor_model.py."""
from .base_model import Model
from .dag_algebra import FactorDAG


class FactorModel(Model):
    def __init__(self, factor_dag):
        if not isinstance(factor_dag, FactorDAG):
            raise TypeError(f"factor_dag {factor_dag} is not a FactorDAG")
        if factor_dag._roots_ph:
            raise ValueError("root placeholders present: missing priors")
        self.factor_dag = factor_dag
        Model.__init__(self, factor_dag.to_model_dag())
