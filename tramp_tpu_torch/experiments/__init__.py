"""Teacher-student scenarios, experiment sweeps and phase-boundary
searches, and the plots. Counterpart of tramp_tpu/experiments."""
from .teacher_student_scenario import (
    TeacherStudentScenario, BayesOptimalScenario, run_state_evolution,
)
from .multiple_experiments import (
    run_experiments, simple_run_experiments, save_experiments,
    log_on_progress, get_experiments_from_kwargs,
)
from .plots import qplot, plot_compare, plot_compare_complex, plot_function
from .critical_alpha import (
    binary_search, find_state_evolution_mse, find_critical_alpha,
    find_critical_alpha_batched,
)

__all__ = [
    "TeacherStudentScenario", "BayesOptimalScenario", "run_state_evolution",
    "run_experiments", "simple_run_experiments", "save_experiments",
    "log_on_progress", "get_experiments_from_kwargs", "binary_search",
    "find_state_evolution_mse", "find_critical_alpha",
    "find_critical_alpha_batched",
    "qplot", "plot_compare", "plot_compare_complex", "plot_function",
]
