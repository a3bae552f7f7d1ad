"""Sparse-gradient regression: recover a piecewise-constant signal from
random projections with the TV-like tree model (a Gauss-Bernoulli prior on
the gradient).

Counterpart of examples/sparse/sparse_gradient.py (reference analog:
examples/sparse/plot_sparse_gradient.py:21-41). The instance comes from
``np.random.RandomState(0)``, as in the JAX script, so both packages solve
the same problem. Float64, as the JAX script runs with x64. Writes a CSV
of (x_true, x_ep).

Run: python -m tramp_tpu_torch.examples.sparse.sparse_gradient [--big]
[--device cpu] [--out DIR]
"""
import os

import numpy as np
import torch

from tramp_tpu_torch.models import sparse_gradient_regression
from tramp_tpu_torch.algos import ExpectationPropagation
from tramp_tpu_torch.examples import _cli


def make_signal(N, n_pieces, rng):
    "Piecewise-constant teacher signal."
    x = np.zeros(N)
    edges = np.sort(rng.choice(np.arange(1, N), n_pieces - 1, replace=False))
    levels = rng.randn(n_pieces)
    start = 0
    for lvl, end in zip(levels, list(edges) + [N]):
        x[start:end] = lvl
        start = end
    return x


def instance(N, alpha=0.6, noise_var=1e-3):
    "(x0, A, y) from RandomState(0)."
    M = int(alpha * N)
    rng = np.random.RandomState(0)
    x0 = make_signal(N, 6, rng)
    A = rng.randn(M, N) / np.sqrt(N)
    y = A @ x0 + np.sqrt(noise_var) * rng.randn(M)
    return x0, A, y


def run(N, device, noise_var=1e-3):
    "(x0, EP's posterior mean of x) on the size-N instance."
    x0, A, y = instance(N, noise_var=noise_var)
    model = sparse_gradient_regression(
        A, y, x_shape=(N,), grad_rho=0.05, noise_var=noise_var,
        prior_var=2.0, device=device, dtype=torch.float64)
    ep = ExpectationPropagation(model)
    ep.iterate(max_iter=200, damping=0.1)
    return x0, ep.get_variable_data("x")["r"].cpu().numpy()


def main(argv=None):
    args = _cli.parser(__doc__, big="N = 400").parse_args(argv)
    device = _cli.device(args)
    N = 400 if args.big else 128
    x0, r = run(N, device)
    mse = float(np.mean((r - x0) ** 2))
    print(f"N={N} M={int(0.6 * N)} sparse-gradient EP mse={mse:.2e} "
          f"(signal var {x0.var():.3f})")
    csv = os.path.join(_cli.out_dir(args, "sparse"),
                       "sparse_gradient_recovery.csv")
    np.savetxt(csv, np.c_[x0, r], delimiter=",", header="x_true,x_ep")
    print(f"wrote {csv}")
    return dict(mse=mse, x0=x0, r=r)


if __name__ == "__main__":
    main()
