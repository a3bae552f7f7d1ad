"""tramp_tpu_torch: the PyTorch and CUDA port of tramp_tpu.

Models are DAGs of priors, channels and likelihoods composed with ``@``
and ``+`` (trees whose factors take several inputs or outputs included:
committees, multi-layer models, the VAE prior, complex phase retrieval);
``ExpectationPropagation(model).iterate(...)`` runs EP message passing over
the statically lowered schedule; ``parallel.dispatch_solver(model)`` picks
the fastest solver for a model, with single and batched solves.
``StateEvolution(model).iterate(...)`` runs the scalar state evolution of
the same model (float64 unless asked otherwise), ``parallel.SESolver`` and
``parallel.run_se_phase_grid`` batch it over a grid of hyperparameters, and
``experiments`` holds the teacher-student scenarios and the critical-line
searches. The piecewise-linear posterior runs as a hand-written CUDA kernel
on NVIDIA Hopper GPUs and as plain PyTorch on the CPU, in the EP readouts
and as the integrand of the piecewise-linear channels' state evolution. The
JAX package tramp_tpu is the reference this port is held against.
"""
from . import (
    beliefs, utils, ops, priors, channels, likelihoods, ensembles, parallel,
    experiments,
)
from .variables import (
    SISOVariable, SIMOVariable, MISOVariable, MILeafVariable,
    SILeafVariable, MORootVariable, SORootVariable, V, O,
)
from .models import (
    Model, DAG, FactorDAG, ModelDAG, FactorModel, glm_generative,
    glm_state_evolution, MultiLayerModel,
)
from .algos import (
    ExpectationPropagation, StateEvolution, ConstantInit, NoisyInit,
    CustomInit, EarlyStopping, EarlyStoppingEP,
)
from .experiments import TeacherStudentScenario, BayesOptimalScenario

__all__ = [
    "beliefs", "utils", "ops", "priors", "channels", "likelihoods",
    "ensembles", "parallel", "experiments", "SISOVariable", "SIMOVariable",
    "MISOVariable", "MILeafVariable", "SILeafVariable", "MORootVariable",
    "SORootVariable", "V", "O", "Model", "DAG", "FactorDAG", "ModelDAG",
    "FactorModel", "glm_generative", "glm_state_evolution",
    "MultiLayerModel",
    "ExpectationPropagation", "StateEvolution", "ConstantInit", "NoisyInit",
    "CustomInit", "EarlyStopping", "EarlyStoppingEP",
    "TeacherStudentScenario", "BayesOptimalScenario",
]
