"""Compressed sensing: EP vs SE across the measurement ratio alpha.

Counterpart of examples/glm/compressed_sensing.py (reference analog:
examples/glm/plot_cs.py:19-23 and
examples/glm/data/compressed_sensing_ep_vs_se.py).

Sweeps alpha, runs EP on a sampled instance and SE on the analytic
Marchenko-Pastur model, and writes a CSV of (v_EP, mse_EP, v_SE, alpha,
seed). Float64, as the JAX script runs with x64.

Run: python -m tramp_tpu_torch.examples.glm.compressed_sensing [--big]
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

EP_ITERATE = dict(max_iter=250, damping=0.1)
SE_ITERATE = dict(max_iter=250)


def solve_ep(student):
    "EP on an observed student, as the JAX script's ``scenario.run_ep``."
    ep = ExpectationPropagation(student)
    ep.iterate(**EP_ITERATE)
    return ep


def ep_columns(ep, x_true):
    "v_EP and mse_EP of a solved engine against the teacher's x."
    x = ep.get_variable_data("x")
    mse = float(torch.mean((x["r"] - x_true) ** 2))
    return dict(v_EP=_cli.mean(x["v"]), mse_EP=mse)


def se_v(alpha, rho, noise_var, device):
    "v_SE of the Marchenko-Pastur model at alpha (float64)."
    se = StateEvolution(glm_state_evolution(
        alpha=alpha, prior_type="gauss_bernoulli", output_type="gaussian",
        prior_rho=rho, output_var=noise_var), device=device)
    se.iterate(**SE_ITERATE)
    return _cli.mean(se.get_variable_data("x")["v"])


def run_cs(alpha, N, rho, noise_var, seed, device):
    model = glm_generative(
        N=N, alpha=alpha, ensemble_type="gaussian",
        prior_type="gauss_bernoulli", output_type="gaussian",
        prior_rho=rho, output_var=noise_var,
        generator=_cli.generator(device, seed), device=device,
        dtype=torch.float64)
    scenario = BayesOptimalScenario(model, x_ids=["x"])
    scenario.setup(seed=seed)
    row = ep_columns(solve_ep(scenario.student), scenario.x_true["x"])
    row["v_SE"] = se_v(alpha, rho, noise_var, device)
    return row


def sizes(big):
    "(N, alphas) of the default or the --big run."
    N = 1000 if big else 250
    alphas = list(np.linspace(0.05, 1.0, 20 if big else 8).round(4))
    return N, alphas


def main(argv=None):
    args = _cli.parser(__doc__, big="N = 1000, 20 alphas").parse_args(argv)
    device = _cli.device(args)
    N, alphas = sizes(args.big)
    csv = os.path.join(_cli.out_dir(args, "glm"),
                       "compressed_sensing_ep_vs_se.csv")
    df = save_experiments(
        lambda alpha, seed: run_cs(alpha, N=N, rho=0.25, noise_var=1e-2,
                                   seed=seed, device=device),
        csv, alpha=alphas, seed=[0])
    print(df.to_string(index=False))
    print(f"wrote {csv}")
    return df


if __name__ == "__main__":
    main()
