"""Universality of noiseless compressed sensing over sensing ensembles.

Counterpart of examples/glm/cs_universality.py (reference analog:
examples/glm/plot_cs_universality.py:12-26 and
examples/glm/data/cs_universality.py:7-27).

The sensing matrix is a random-features matrix F = f(WX)/sqrt(N) with f in
{abs, sgn, relu, tanh}; the EP and SE MSE curves are expected to collapse
onto the Gaussian ensemble's (universality). Writes a CSV of (source, x_id,
v, n_iter, f, prior_rho, alpha); float64, as the JAX script runs with x64.

Run: python -m tramp_tpu_torch.examples.glm.cs_universality [--big]
[--device cpu] [--out DIR] [--plot]
"""
import os

import numpy as np
import torch

from tramp_tpu_torch import glm_generative
from tramp_tpu_torch.algos import EarlyStopping
from tramp_tpu_torch.experiments import BayesOptimalScenario, save_experiments
from tramp_tpu_torch.examples import _cli

FUNCTIONS = ["abs", "sgn", "relu", "tanh"]


def run_cs(N, alpha, f, prior_rho, device, seed=0):
    model = glm_generative(
        N=N, alpha=alpha, ensemble_type="random_feature",
        prior_type="gauss_bernoulli", output_type="gaussian",
        ensemble_f=f, prior_rho=prior_rho, output_var=1e-11,
        generator=_cli.generator(device, seed), device=device,
        dtype=torch.float64)
    scenario = BayesOptimalScenario(model, x_ids=["x"])
    # v-based EarlyStopping works for both the SE and EP passes of run_all
    # (reference data/cs_universality.py:14-17)
    return scenario.run_all(metrics=["mse"], seed=seed, max_iter=200,
                            callback=EarlyStopping())


def sizes(big):
    "(N, alphas, rhos) of the default or the --big run."
    N = 1000 if big else 250
    n_alpha = 20 if big else 6
    alphas = list(np.linspace(0, 1, n_alpha + 1)[1:].round(4))
    rhos = [0.25, 0.50, 0.75] if big else [0.25, 0.5]
    return N, alphas, rhos


def main(argv=None):
    args = _cli.parser(__doc__, big="N = 1000, 20 alphas, 3 rhos",
                       plot=True).parse_args(argv)
    device = _cli.device(args)
    N, alphas, rhos = sizes(args.big)
    out = _cli.out_dir(args, "glm")
    csv = os.path.join(out, "cs_universality.csv")
    df = save_experiments(
        lambda alpha, f, prior_rho: run_cs(N, alpha, f, prior_rho, device),
        csv, f=FUNCTIONS, prior_rho=rhos, alpha=alphas)
    print(df.to_string(index=False))
    print(f"wrote {csv}")
    if args.plot:
        from tramp_tpu_torch.experiments import qplot
        ax = qplot(df.query("source=='SE'"), x="alpha", y="v",
                   linestyle="f", column="prior_rho")
        fig = (ax[0] if isinstance(ax, (list, np.ndarray)) else ax).figure
        fig.savefig(os.path.join(out, "cs_universality.png"), dpi=120)
    return df


if __name__ == "__main__":
    main()
