"""Model DSL: DAG algebra, the lowered Model, the GLM builders and the
composite models."""
from .graph import DiGraph
from .dag_algebra import (
    DAG, FactorDAG, ModelDAG, PlaceHolder, RootPlaceHolder, LeafPlaceHolder,
)
from .base_model import Model
from .factor_model import FactorModel
from .generalized_linear_model import glm_generative, glm_state_evolution
from .multi_layer_model import MultiLayerModel
from .committee_model import committee, sgn_committee, soft_committee
from .vae_prior import (
    vae_prior_block, vae_prior_from_h5, load_vae_decoder_weights)
from .total_variation_model import (
    sparse_gradient_block, tv_block, regression_block, classification_block,
    sparse_gradient_regression, sparse_gradient_classification,
    tv_regression, tv_classification,
)

__all__ = ["DiGraph", "Model", "DAG", "FactorDAG", "ModelDAG",
           "PlaceHolder", "RootPlaceHolder", "LeafPlaceHolder", "FactorModel",
           "glm_generative", "glm_state_evolution", "MultiLayerModel",
           "committee", "sgn_committee", "soft_committee",
           "vae_prior_block", "vae_prior_from_h5",
           "load_vae_decoder_weights", "sparse_gradient_block", "tv_block",
           "regression_block", "classification_block",
           "sparse_gradient_regression", "sparse_gradient_classification",
           "tv_regression", "tv_classification"]
