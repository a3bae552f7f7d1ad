"""Perceptron: sgn-output GLM, EP vs SE across alpha.

Counterpart of examples/glm/perceptron.py (reference analog:
examples/glm/data/perceptron_ep_vs_se.py:7-16). Writes a CSV of (v_EP,
mse_EP, v_SE, alpha, seed); float64, as the JAX script runs with x64.

Run: python -m tramp_tpu_torch.examples.glm.perceptron [--big]
[--device cpu] [--out DIR]
"""
import os

import numpy as np
import torch

from tramp_tpu_torch import (
    glm_generative, glm_state_evolution, StateEvolution,
    ExpectationPropagation)
from tramp_tpu_torch.experiments import BayesOptimalScenario, save_experiments
from tramp_tpu_torch.examples import _cli
from tramp_tpu_torch.examples.glm.compressed_sensing import ep_columns

EP_ITERATE = dict(max_iter=250)
SE_ITERATE = dict(max_iter=250)


def solve_ep(student):
    "EP on an observed student, as the JAX script's ``scenario.run_ep``."
    ep = ExpectationPropagation(student)
    ep.iterate(**EP_ITERATE)
    return ep


def se_v(alpha, device):
    "v_SE of the binary-prior sgn-output model at alpha (float64)."
    se = StateEvolution(glm_state_evolution(
        alpha=alpha, prior_type="binary", output_type="sgn"), device=device)
    se.iterate(**SE_ITERATE)
    return _cli.mean(se.get_variable_data("x")["v"])


def run_perceptron(alpha, N, seed, device):
    model = glm_generative(
        N=N, alpha=alpha, ensemble_type="gaussian",
        prior_type="binary", output_type="sgn",
        generator=_cli.generator(device, seed), device=device,
        dtype=torch.float64)
    scenario = BayesOptimalScenario(model, x_ids=["x"])
    scenario.setup(seed=seed)
    row = ep_columns(solve_ep(scenario.student), scenario.x_true["x"])
    row["v_SE"] = se_v(alpha, device)
    return row


def sizes(big):
    "(N, alphas) of the default or the --big run."
    N = 1000 if big else 250
    alphas = list(np.linspace(0.2, 2.0, 19 if big else 7).round(4))
    return N, alphas


def main(argv=None):
    args = _cli.parser(__doc__, big="N = 1000, 19 alphas").parse_args(argv)
    device = _cli.device(args)
    N, alphas = sizes(args.big)
    csv = os.path.join(_cli.out_dir(args, "glm"), "perceptron_ep_vs_se.csv")
    df = save_experiments(
        lambda alpha, seed: run_perceptron(alpha, N=N, seed=seed,
                                           device=device),
        csv, alpha=alphas, seed=[0])
    print(df.to_string(index=False))
    print(f"wrote {csv}")
    return df


if __name__ == "__main__":
    main()
