"""EP wall time on sparse linear regression, against scikit-learn's
LassoCV when it is importable.

Counterpart of examples/figures/benchmark.py (reference analog:
examples/figures/compute_benchmark.py:16-93: EP against LassoCV and
PyMC3-NUTS; PyMC3 is not installable offline, Lasso is optional and its
columns are NaN without scikit-learn). EP's time includes building the
model and its SVD, like the reference (l:21-28). Float64, as the JAX
script runs with x64. Writes a CSV of (ep_mse, ep_time, lasso_mse,
lasso_time, alpha, seed).

Run: python -m tramp_tpu_torch.examples.figures.benchmark [--big]
[--device cpu] [--out DIR]
"""
import os
import time

import numpy as np
import torch

from tramp_tpu_torch import glm_generative
from tramp_tpu_torch.experiments import BayesOptimalScenario, save_experiments
from tramp_tpu_torch.examples import _cli


def scenario_of(alpha, N, rho, noise_var, seed, device):
    model = glm_generative(
        N=N, alpha=alpha, ensemble_type="gaussian",
        prior_type="gauss_bernoulli", output_type="gaussian",
        prior_rho=rho, output_var=noise_var,
        generator=_cli.generator(device, seed), device=device,
        dtype=torch.float64)
    scenario = BayesOptimalScenario(model, x_ids=["x"])
    scenario.setup(seed=seed)
    return model, scenario


def run_ep(alpha, N, rho, noise_var, seed, device):
    t0 = time.perf_counter()
    _, scenario = scenario_of(alpha, N, rho, noise_var, seed, device)
    x_ep = scenario.run_ep(max_iter=1000, damping=0.1)
    mse = float(torch.mean((x_ep["x"]["r"] - scenario.x_true["x"]) ** 2))
    return dict(source="EP", mse=mse, time=time.perf_counter() - t0)


def run_lasso(alpha, N, rho, noise_var, seed, device):
    try:
        from sklearn.linear_model import LassoCV
    except ImportError:
        return dict(source="Lasso", mse=np.nan, time=np.nan)
    model, scenario = scenario_of(alpha, N, rho, noise_var, seed, device)
    F = model.factors[1].W.cpu().numpy()
    y = scenario.observations["y"].cpu().numpy()
    x_true = scenario.x_true["x"].cpu().numpy()
    t0 = time.perf_counter()
    reg = LassoCV(cv=5).fit(F, y)
    mse = float(np.mean((reg.coef_ - x_true) ** 2))
    return dict(source="Lasso", mse=mse, time=time.perf_counter() - t0)


def sizes(big):
    "(N, alphas) of the default or the --big run."
    if big:
        return 1000, list(np.linspace(0.02, 1.0, 25).round(3))
    return 250, [0.1, 0.3, 0.6]


def main(argv=None):
    args = _cli.parser(__doc__, big="N = 1000, 25 alphas").parse_args(argv)
    device = _cli.device(args)
    N, alphas = sizes(args.big)

    def run(alpha, seed):
        out = run_ep(alpha, N=N, rho=0.05, noise_var=1e-2, seed=seed,
                     device=device)
        lasso = run_lasso(alpha, N=N, rho=0.05, noise_var=1e-2, seed=seed,
                          device=device)
        return dict(ep_mse=out["mse"], ep_time=out["time"],
                    lasso_mse=lasso["mse"], lasso_time=lasso["time"])

    csv = os.path.join(_cli.out_dir(args, "figures"), "benchmark.csv")
    df = save_experiments(run, csv, alpha=alphas, seed=[0, 1])
    print(df.to_string(index=False))
    print(f"wrote {csv}")
    return df


if __name__ == "__main__":
    main()
