"""JMLR figure: sparse linear regression MSE vs alpha; EP, SE, Bayes opt.

Counterpart of examples/figures/sparse_regression.py (reference analog:
examples/figures/sparse_regression.py, run_EP l:49-60, run_SE l:63-73,
run_BO l:76-88, protocol l:90-106: EP on N=2000 instances averaged over 25
seeds, SE/BO on 100-point alpha grids, BO with the informed init
a0 = 10**(3*exp(alpha))).

Per alpha the EP seeds are the lanes of one ``EPSolver.solve_batch`` (the
students stacked with ``stack_models``: an operator per lane); the SE and
BO alpha grids are each one ``SESolver.solve_batch`` with alpha a per-lane
hyperparameter of the Marchenko-Pastur channel, the BO's informed inits a
list of ``CustomInit``, one per lane. Float64, as the JAX script runs with
x64. Writes a CSV of (source, alpha, rho, v).

Run: python -m tramp_tpu_torch.examples.figures.sparse_regression [--big]
[--device cpu] [--out DIR] [--plot]
"""
import logging
import os

import numpy as np
import torch

from tramp_tpu_torch import glm_generative, glm_state_evolution
from tramp_tpu_torch.algos import CustomInit
from tramp_tpu_torch.algos.metrics import mean_squared_error
from tramp_tpu_torch.experiments import BayesOptimalScenario
from tramp_tpu_torch.parallel import EPSolver, SESolver, stack_models
from tramp_tpu_torch.examples import _cli

RHO, NOISE_VAR = 0.5, 1e-10
EP_SOLVE = dict(max_iter=200, tol=1e-6)
SE_SOLVE = dict(max_iter=200, tol=1e-6)


def students(alpha, N, rho, noise_var, n_seeds, device):
    "(students, x_true) of seeds 0 .. n_seeds - 1 at alpha."
    out, x_true = [], []
    for seed in range(n_seeds):
        model = glm_generative(
            N=N, alpha=float(alpha), ensemble_type="gaussian",
            prior_type="gauss_bernoulli", output_type="gaussian",
            prior_rho=rho, output_var=noise_var,
            generator=_cli.generator(device, seed), device=device,
            dtype=torch.float64)
        sc = BayesOptimalScenario(model, x_ids=["x"])
        sc.setup(seed=seed)
        out.append(sc.student)
        x_true.append(sc.x_true["x"])
    return out, x_true


def ep_batch(students, x_true):
    """The seeds as lanes of one batched solve: (each seed's mse,
    post, n_iter)."""
    solver = EPSolver(students[0], **EP_SOLVE)
    post, n_iter = solver.solve_batch(stack_models(students))
    r = post["x"]["r"]
    mses = np.array([mean_squared_error(r[i], x_true[i])
                     for i in range(len(students))])
    return mses, post, n_iter


def run_ep_curve(alphas, N, rho, noise_var, n_seeds, device):
    "Per alpha: n_seeds EP instances as one batched solve; mean mse."
    records = []
    for alpha in alphas:
        mses = ep_batch(*students(alpha, N, rho, noise_var, n_seeds,
                                  device))[0]
        records.append(dict(source="EP", alpha=float(alpha), rho=rho,
                            v=float(np.mean(mses))))
    return records


def run_se_curve(alphas, rho, noise_var, source, device):
    "One batched SE solve over the alpha grid (uninformed SE or informed BO)."
    models = [
        glm_state_evolution(
            alpha=float(a), prior_type="gauss_bernoulli",
            output_type="gaussian", prior_rho=rho, output_var=noise_var)
        for a in alphas
    ]
    solver = SESolver(models[0], device=device, **SE_SOLVE)
    if source == "BO":
        # informed init scaled to avoid issues at low alpha (reference l:82-84)
        inits = [CustomInit(a_init=[("x", "bwd", 10.0 ** (3 * np.exp(a)))])
                 for a in alphas]
    else:
        inits = None
    post, n_iter = solver.solve_batch(stack_models(models, device=device),
                                      initializer=inits)
    v = post["x"]["v"].double().cpu().numpy().reshape(len(alphas), -1)
    return [dict(source=source, alpha=float(a), rho=rho, v=float(vi))
            for a, vi in zip(alphas, v.mean(axis=1))]


def grids(big):
    "(N, n_seeds, EP alphas, SE alphas) of the default or the --big run."
    if big:
        return 2000, 25, np.linspace(0.03, 0.99, 33), \
            np.linspace(0.01, 1.0, 100)
    return 250, 4, np.linspace(0.03, 0.99, 9), np.linspace(0.01, 1.0, 25)


def plot(df, out, what, yscale):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 6))
    d = df[df.source == "EP"]
    ax.plot(d["alpha"], d["v"], "C1o", label="EP")
    d = df[df.source == "SE"].sort_values("alpha")
    ax.plot(d["alpha"], d["v"], "C0-", label="SE")
    d = df[df.source == "BO"].sort_values("alpha")
    ax.plot(d["alpha"], d["v"], "C2--", label="Bayes opt.")
    ax.set(xlabel="alpha", ylabel="MSE", yscale=yscale)
    ax.legend()
    fig.tight_layout()
    path = os.path.join(out, f"{what}.png")
    fig.savefig(path, dpi=120)
    print(f"wrote {path}")


def main(argv=None):
    import pandas as pd
    args = _cli.parser(
        __doc__, big="full JMLR protocol (N=2000, 25 seeds, 100-pt grids)",
        plot=True).parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = _cli.device(args)
    N, n_seeds, alphas, se_alphas = grids(args.big)
    df = pd.DataFrame(
        run_ep_curve(alphas, N, RHO, NOISE_VAR, n_seeds, device)
        + run_se_curve(se_alphas, RHO, NOISE_VAR, "SE", device)
        + run_se_curve(se_alphas, RHO, NOISE_VAR, "BO", device))
    out = _cli.out_dir(args, "figures")
    csv = os.path.join(out, "sparse_regression.csv")
    df.to_csv(csv, index=False)
    print(df.groupby("source")["v"].describe().to_string())
    print(f"wrote {csv}")
    if args.plot:
        plot(df, out, "sparse_regression", "log")
    return df


if __name__ == "__main__":
    main()
