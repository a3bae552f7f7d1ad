"""JMLR figure: sparse phase retrieval (y = |Fx|, real); EP, SE, Bayes opt.

Counterpart of examples/figures/sparse_phase_retrieval.py (reference
analog: examples/figures/sparse_phase_retrieval.py, run_EP l:49-62, run_SE
l:65-78, run_BO l:81-94, protocol l:97-116: abs output, prior_mean=0.01
symmetry breaking, rho=0.6, EP damping 0.3 with
EarlyStopping(wait_increase=10), SE uninformed init a0=0.1, BO informed
init a0=1e3, sign-symmetric mse).

Per alpha the EP seeds are the lanes of one ``EPSolver.solve_batch``; the
SE and BO alpha grids are each one ``SESolver.solve_batch`` with a
``CustomInit`` per grid point. Float64, as the JAX script runs with x64.
Writes a CSV of (source, alpha, rho, v).

Run: python -m tramp_tpu_torch.examples.figures.sparse_phase_retrieval
[--big] [--device cpu] [--out DIR] [--plot]
"""
import logging
import os

import numpy as np
import torch

from tramp_tpu_torch import glm_generative, glm_state_evolution
from tramp_tpu_torch.algos import CustomInit
from tramp_tpu_torch.algos.metrics import sign_symmetric_mse
from tramp_tpu_torch.experiments import BayesOptimalScenario
from tramp_tpu_torch.parallel import EPSolver, SESolver, stack_models
from tramp_tpu_torch.examples import _cli
from tramp_tpu_torch.examples.figures.sparse_regression import plot

RHO = 0.6
# wait_increase=10: tolerate the symmetry-breaking transient
# (reference sparse_phase_retrieval.py:57 EarlyStopping(wait_increase=10))
EP_SOLVE = dict(damping=0.3, max_iter=200, tol=1e-6, wait_increase=10)
SE_SOLVE = dict(max_iter=200, tol=1e-6)


def students(alpha, N, rho, n_seeds, device):
    "(students, x_true) of seeds 0 .. n_seeds - 1 at alpha."
    out, x_true = [], []
    for seed in range(n_seeds):
        model = glm_generative(
            N=N, alpha=float(alpha), ensemble_type="gaussian",
            prior_type="gauss_bernoulli", output_type="abs",
            prior_rho=rho, prior_mean=0.01,
            generator=_cli.generator(device, seed), device=device,
            dtype=torch.float64)
        sc = BayesOptimalScenario(model, x_ids=["x"])
        sc.setup(seed=seed)
        out.append(sc.student)
        x_true.append(sc.x_true["x"])
    return out, x_true


def ep_batch(students, x_true):
    """The seeds as lanes of one batched solve: (each seed's
    sign-symmetric mse, post, n_iter)."""
    solver = EPSolver(students[0], **EP_SOLVE)
    post, n_iter = solver.solve_batch(stack_models(students))
    r = post["x"]["r"]
    mses = np.array([sign_symmetric_mse(r[i], x_true[i])
                     for i in range(len(students))])
    return mses, post, n_iter


def run_ep_curve(alphas, N, rho, n_seeds, device):
    records = []
    for alpha in alphas:
        mses = ep_batch(*students(alpha, N, rho, n_seeds, device))[0]
        records.append(dict(source="EP", alpha=float(alpha), rho=rho,
                            v=float(np.mean(mses))))
    return records


def run_se_curve(alphas, rho, source, device):
    models = [
        glm_state_evolution(
            alpha=float(a), prior_type="gauss_bernoulli", output_type="abs",
            prior_rho=rho, prior_mean=0.01)
        for a in alphas
    ]
    solver = SESolver(models[0], device=device, **SE_SOLVE)
    a0 = 1e3 if source == "BO" else 0.1  # reference l:72,89
    inits = [CustomInit(a_init=[("x", "bwd", a0)]) for _ in alphas]
    post, _ = solver.solve_batch(stack_models(models, device=device),
                                 initializer=inits)
    v = post["x"]["v"].double().cpu().numpy().reshape(len(alphas), -1)
    return [dict(source=source, alpha=float(a), rho=rho, v=float(vi))
            for a, vi in zip(alphas, v.mean(axis=1))]


def grids(big):
    "(N, n_seeds, EP alphas, SE alphas) of the default or the --big run."
    if big:
        return 2000, 25, np.linspace(0.03, 1.2, 40), \
            np.linspace(0.01, 1.2, 120)
    return 250, 4, np.linspace(0.03, 1.2, 8), np.linspace(0.01, 1.2, 25)


def main(argv=None):
    import pandas as pd
    args = _cli.parser(
        __doc__, big="full JMLR protocol (N=2000, 25 seeds, 120-pt grids)",
        plot=True).parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = _cli.device(args)
    N, n_seeds, alphas, se_alphas = grids(args.big)
    df = pd.DataFrame(
        run_ep_curve(alphas, N, RHO, n_seeds, device)
        + run_se_curve(se_alphas, RHO, "SE", device)
        + run_se_curve(se_alphas, RHO, "BO", device))
    out = _cli.out_dir(args, "figures")
    csv = os.path.join(out, "sparse_phase_retrieval.csv")
    df.to_csv(csv, index=False)
    print(df.groupby("source")["v"].describe().to_string())
    print(f"wrote {csv}")
    if args.plot:
        plot(df, out, "sparse_phase_retrieval", "linear")
    return df


if __name__ == "__main__":
    main()
