"""Model DSL: DAG algebra, the lowered Model and the GLM builders."""
from .base_model import Model
from .dag_algebra import DAG, ModelDAG
from .generalized_linear_model import glm_generative, glm_state_evolution

__all__ = ["Model", "DAG", "ModelDAG", "glm_generative",
           "glm_state_evolution"]
