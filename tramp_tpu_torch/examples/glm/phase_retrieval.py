"""Complex phase retrieval: y = |F x| with a complex Gaussian sensing
matrix.

Counterpart of examples/glm/phase_retrieval.py (reference analog:
examples/glm/plot_complex_pr.py). Complex variables are packed as (2, .)
real planes; the metric is the phase-symmetric mse. Writes a CSV of (mse_EP,
v_EP, alpha, seed); float64, as the JAX script runs with x64.

Run: python -m tramp_tpu_torch.examples.glm.phase_retrieval [--big]
[--device cpu] [--out DIR]
"""
import os

import numpy as np
import torch

from tramp_tpu_torch import glm_generative
from tramp_tpu_torch.algos import EarlyStopping
from tramp_tpu_torch.algos.metrics import phase_symmetric_mse
from tramp_tpu_torch.experiments import BayesOptimalScenario, save_experiments
from tramp_tpu_torch.examples import _cli


def run_pr(alpha, N, seed, device):
    # small nonzero prior mean breaks the global phase symmetry
    # (reference plot_complex_pr.py:20-24: prior_mean=0.01, rho=0.5)
    model = glm_generative(
        N=N, alpha=alpha, ensemble_type="complex_gaussian",
        prior_type="gauss_bernoulli", output_type="modulus",
        prior_mean=0.01, prior_rho=0.5,
        generator=_cli.generator(device, seed), device=device,
        dtype=torch.float64)
    scenario = BayesOptimalScenario(model, x_ids=["x"])
    scenario.setup(seed=seed)
    # reference data script: EarlyStopping(wait_increase=10) (v-based),
    # damping 0.3 (phase_retrieval_ep_vs_se.py:14-18)
    x_ep = scenario.run_ep(max_iter=200, damping=0.3,
                           early_stop=EarlyStopping(wait_increase=10))
    mse = phase_symmetric_mse(scenario.x_true["x"], x_ep["x"]["r"])
    return dict(mse_EP=float(mse), v_EP=_cli.mean(x_ep["x"]["v"]))


def sizes(big):
    "(N, alphas) of the default or the --big run."
    if big:
        return 500, list(np.linspace(1.0, 4.0, 13).round(3))
    return 120, [1.5, 2.0, 3.0]


def main(argv=None):
    args = _cli.parser(__doc__, big="N = 500, 13 alphas").parse_args(argv)
    device = _cli.device(args)
    N, alphas = sizes(args.big)
    csv = os.path.join(_cli.out_dir(args, "glm"), "phase_retrieval_ep.csv")
    df = save_experiments(
        lambda alpha, seed: run_pr(alpha, N=N, seed=seed, device=device),
        csv, alpha=alphas, seed=[0])
    print(df.to_string(index=False))
    print(f"wrote {csv}")
    return df


if __name__ == "__main__":
    main()
