"""Model DSL: DAG algebra and the lowered Model."""
from .base_model import Model
from .dag_algebra import DAG, ModelDAG

__all__ = ["Model", "DAG", "ModelDAG"]
