"""GLM builders. Counterpart of
tramp_tpu/models/generalized_linear_model.py. Every prior and output type
of the JAX registries builds; ``output_type="modulus"`` builds the complex
GLM of phase retrieval: a prior over packed (2, N) complex x and a
``ComplexLinearChannel``."""
from ..channels import get_channel
from ..ensembles import get_ensemble
from ..likelihoods import get_likelihood
from ..priors import get_prior
from ..variables import SISOVariable as V, SILeafVariable as O


def get_kwargs(target, kwargs):
    "Prefix-routed kwargs (prior_*, output_*, ensemble_*). Reference l:8-14."
    n = len(target) + 1
    return {k[n:]: v for k, v in kwargs.items() if k.startswith(target)}


def glm_generative(N, alpha, ensemble_type, prior_type, output_type,
                   generator=None, device=None, dtype=None, **kwargs):
    """Generative GLM: prior @ x @ linear @ z @ output @ y. Reference
    l:17-35. ``generator`` draws the matrix; ``device`` and ``dtype`` are
    those of the model's arrays (None: the first card, the default
    dtype)."""
    M = int(alpha * N)
    ensemble = get_ensemble(ensemble_type, M=M, N=N,
                            **get_kwargs("ensemble", kwargs))
    F = ensemble.generate(generator, device=device, dtype=dtype)
    complex_glm = output_type == "modulus"
    prior = get_prior(size=(2, N) if complex_glm else N,
                      prior_type=prior_type, device=device, dtype=dtype,
                      **get_kwargs("prior", kwargs))
    linear = get_channel("complex_linear" if complex_glm else "linear",
                         W=F, name="F")
    output = get_channel(channel_type=output_type,
                         **get_kwargs("output", kwargs))
    return (
        prior @ V(id="x") @ linear @ V(id="z") @ output @ O(id="y")
    ).to_model()


def glm_state_evolution(alpha, prior_type, output_type, **kwargs):
    "SE-only GLM with Marchenko-Pastur linear channel. Reference l:38-55."
    prior = get_prior(size=1, prior_type=prior_type,
                      **get_kwargs("prior", kwargs))
    linear = get_channel("marchenko", alpha=alpha, name="F")
    output = get_likelihood(
        y=None, y_name="y", likelihood_type=output_type,
        **get_kwargs("output", kwargs))
    return (prior @ V(id="x") @ linear @ V(id="z") @ output).to_model()
