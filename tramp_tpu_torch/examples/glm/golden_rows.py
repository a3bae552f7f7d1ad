"""The EP golden rows of the JAX package's tests/test_ep_golden.py and the
ensemble that is held to them.

The reference's committed CSVs pin v_EP (the converged EP posterior
variance) and the empirical mse of one N = 1000 instance per (alpha, rho)
(reference examples/glm/data/compressed_sensing_ep_vs_se.py:7-27 and
perceptron_ep_vs_se.py:7-16). The reference instances cannot be replayed,
so the contract is statistical: the CSV value is one draw of the instance
distribution; ``run_ensemble`` draws N_SEEDS instances as the lanes of one
``EPSolver.solve_batch``, and ``in_band`` holds the CSV draw within the
ensemble's finite-N band, |mean - csv| <= 3.3 sd + atol (3.3 = 3 sqrt(1 +
1 / N_SEEDS) rounded up), and the ensemble's v_EP within the same band of
v_SE plus 5% of v_SE. The rows are a copy of that test file's (a test of
this repo checks that they stay equal); this module imports no JAX.
Float64.
"""
import math

import numpy as np
import torch

import tramp_tpu_torch as tt
from tramp_tpu_torch.parallel import EPSolver, stack_models
from tramp_tpu_torch.examples import _cli

N_SEEDS = 8
N = 1000
BAND_SDS = 3.3

# (alpha, rho, v_SE_csv, v_EP_csv, mse_csv, atol) — reference
# compressed_sensing_ep_vs_se.csv rows at rho=0.25 where EP converged
CS_EP_ROWS = [
    (0.02040816326530612, 0.25,
     0.2449736425973765, 0.2468006782454586, 0.2731001954228221, 0.0),
    (0.2040816326530612, 0.25,
     0.182124943349197, 0.1729345336714338, 0.19236415075857102, 0.0),
    # deep-recovery branch: v ~ 1e-8 fluctuates multiplicatively; atol
    # covers the scale of both the CSV draw and our draws
    (0.8163265306122448, 0.25,
     5.5538359406470276e-08, 8.977752930825822e-09, 9.120211555173712e-09,
     1e-7),
]

# (alpha, p_pos, v_SE_csv, v_EP_csv, mse_csv) — reference
# perceptron_ep_vs_se.csv rows at p_pos=0.25
PERCEPTRON_EP_ROWS = [
    (0.02, 0.25, 0.7414219343897764, 0.7401054839825113, 0.7378951585127177),
    (0.5, 0.25, 0.531372205233981, 0.5390421435770469, 0.5003689302069502),
    (1.0, 0.25, 0.31072880209244685, 0.31209597643165743,
     0.30408800689296206),
]


def _operator(alpha, generator, device, n=N):
    M = int(math.ceil(alpha * n))
    return torch.randn((M, n), generator=generator, device=device,
                       dtype=torch.float64) / math.sqrt(n)


def build_cs(alpha, rho, generator, device, n=N, noise_var=1e-11):
    "(student, x) of one compressed-sensing instance."
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    from tramp_tpu_torch.channels import LinearChannel, GaussianChannel
    W = _operator(alpha, generator, device, n)
    teacher = (
        GaussBernoulliPrior(size=n, rho=rho, device=device,
                            dtype=torch.float64)
        @ tt.V(id="x") @ LinearChannel(W, name="W") @ tt.V(id="z")
        @ GaussianChannel(var=noise_var) @ tt.O(id="y")
    ).to_model()
    sample = teacher.sample(generator)
    return teacher.to_observed({"y": sample["y"]}), sample["x"]


def build_perceptron(alpha, p_pos, generator, device, n=N):
    "(student, x) of one perceptron instance (the sgn channel observed)."
    from tramp_tpu_torch.priors import BinaryPrior
    from tramp_tpu_torch.channels import LinearChannel, SgnChannel
    W = _operator(alpha, generator, device, n)
    teacher = (
        BinaryPrior(size=n, p_pos=p_pos, device=device, dtype=torch.float64)
        @ tt.V(id="x") @ LinearChannel(W, name="W") @ tt.V(id="z")
        @ SgnChannel() @ tt.O(id="y")
    ).to_model()
    sample = teacher.sample(generator)
    return teacher.to_observed({"y": sample["y"]}), sample["x"]


def run_ensemble(builder, device, n_seeds=N_SEEDS, max_iter=200):
    """v_EP and the empirical mse of each of n_seeds instances, solved as
    the lanes of one batch; builder(generator) -> (student, x). Returns
    (v_ep, mse, n_iter), numpy arrays of n_seeds."""
    models, x0s = zip(*[builder(_cli.generator(device, seed))
                        for seed in range(n_seeds)])
    solver = EPSolver(models[0], damping=None, max_iter=max_iter, tol=1e-6)
    post, n_iter = solver.solve_batch(stack_models(list(models)))
    r = post["x"]["r"].double().cpu().numpy()
    v = post["x"]["v"].double().cpu().numpy()
    x0 = torch.stack(x0s).double().cpu().numpy()
    return (v.reshape(n_seeds, -1).mean(axis=1), ((r - x0) ** 2).mean(axis=1),
            n_iter.cpu().numpy())


def in_band(ours, value, atol=0.0):
    """(inside, |mean - value|, band) of the ensemble ``ours`` against one
    draw ``value``: band = 3.3 sd + atol."""
    gap = abs(float(np.mean(ours)) - value)
    band = BAND_SDS * float(np.std(ours, ddof=1)) + atol
    return gap <= band, gap, band


def hold_rows(device, n=N, n_seeds=N_SEEDS):
    """Every row of both families: a record per row with the ensemble's
    mean v_EP and mse and, for each of the three checks (v_EP against the
    CSV's, mse against the CSV's, v_EP against v_SE), (inside, gap,
    band)."""
    records = []
    for alpha, rho, v_se, v_ep_csv, mse_csv, atol in CS_EP_ROWS:
        v_ep, mse, n_iter = run_ensemble(
            lambda g: build_cs(alpha, rho, g, device, n), device, n_seeds)
        records.append(_record("cs", alpha, v_ep, mse, n_iter, v_se,
                               v_ep_csv, mse_csv, atol))
    for alpha, p_pos, v_se, v_ep_csv, mse_csv in PERCEPTRON_EP_ROWS:
        v_ep, mse, n_iter = run_ensemble(
            lambda g: build_perceptron(alpha, p_pos, g, device, n), device,
            n_seeds)
        records.append(_record("perceptron", alpha, v_ep, mse, n_iter, v_se,
                               v_ep_csv, mse_csv, 0.0))
    return records


def _record(family, alpha, v_ep, mse, n_iter, v_se, v_ep_csv, mse_csv,
            atol):
    return dict(
        family=family, alpha=alpha, v_ep=float(np.mean(v_ep)),
        mse=float(np.mean(mse)), n_iter=int(np.max(n_iter)),
        checks={"v_EP": in_band(v_ep, v_ep_csv, atol),
                "mse": in_band(mse, mse_csv, atol),
                "v_EP_vs_SE": in_band(v_ep, v_se, atol + 0.05 * v_se)})


def main(argv=None):
    args = _cli.parser(__doc__).parse_args(argv)
    records = hold_rows(_cli.device(args))
    for rec in records:
        print(f"{rec['family']} alpha={rec['alpha']:.4g}: v_EP "
              f"{rec['v_ep']:.6g} mse {rec['mse']:.6g} n_iter<="
              f"{rec['n_iter']}; " + ", ".join(
                  f"{k} {'in' if ok else 'OUT OF'} band ({gap:.3g} <= "
                  f"{band:.3g})" for k, (ok, gap, band)
                  in rec["checks"].items()))
    return records


if __name__ == "__main__":
    main()
