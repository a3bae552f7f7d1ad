"""Low-rank matrix factorization x = u v^T / sqrt(N): recover the planted
factors from a noisy matrix observation with the VAMP solver, and compare
the empirical (gauge-invariant) x-space error with the Bayes-optimal K x K
state-evolution prediction across a noise sweep.

Counterpart of examples/low_rank/matrix_factorization.py (reference
analog: the standalone training loop of
tramp/channels/low_rank/AMP_matrix_factorization.py:464-491 and the SE
fixed point of SE_matrix_factorization.py:85-141). The instances come from
``np.random.RandomState(7)`` per Delta, as in the JAX script, and the
seeds of one Delta are the lanes of one solve. Float64, as the JAX script
(at float32 the small-N high-SNR end of the sweep can diverge). The solve
is chaotic in its first iterations: it moves its end point by about 1e-3
under a 1e-13 change of its input, so mse_x_emp agrees with another
package's run only to that order. Writes a CSV of (delta, mse_x_emp,
mse_x_se, vz_u).

Run: python -m tramp_tpu_torch.examples.low_rank.matrix_factorization
[--big] [--seeds S] [--device cpu] [--out DIR]
"""
import math
import os

import numpy as np
import torch

from tramp_tpu_torch.channels.low_rank import (
    vamp_matrix_factorization, se_matrix_factorization_kk)
from tramp_tpu_torch.examples import _cli

K = 2


def planted_instance(M, N, K, Delta, rng):
    u0 = rng.randn(M, K)
    v0 = rng.randn(N, K)
    X0 = u0 @ v0.T / np.sqrt(N)
    Y = X0 + np.sqrt(Delta) * rng.randn(M, N)
    return X0, Y


def deltas(big):
    # the Delta=0.1 (high-SNR) point needs N >= ~512 to concentrate: at
    # small N a seed-level gauge drift inflates the empirical error well
    # above the (asymptotic) SE prediction
    return ([0.1] if big else []) + [0.2, 0.4, 0.7, 1.0]


def mse_empirical(Delta, M, N, seeds, device):
    "(mse_x_emp, vz_u) of the seeds of RandomState(7) at Delta, as lanes."
    kw = dict(device=device, dtype=torch.float64)
    rng = np.random.RandomState(7)
    X0s, Ys = zip(*[planted_instance(M, N, K, Delta, rng)
                    for _ in range(seeds)])
    ru, vu, rv, vv = vamp_matrix_factorization(
        au=1.0, av=1.0, bu=torch.zeros((M, K), **kw),
        bv=torch.zeros((N, K), **kw), ax=1.0 / Delta,
        bx=torch.as_tensor(np.stack(Ys), **kw) / Delta, model="UV")
    Xh = torch.einsum("smk,snk->smn", ru, rv) / math.sqrt(N)
    mse_x = float(torch.mean((Xh - torch.as_tensor(np.stack(X0s), **kw))
                             ** 2))
    return mse_x, _cli.mean(vu)


def mse_se(Delta, M, N, device):
    """The Bayes-optimal prediction from the K x K overlap recursion:
    mse_x = (K - tr(q_u q_v)) / N with q = Sigma - mse (Nishimori)."""
    mse_u, mse_v = se_matrix_factorization_kk(
        au=1.0, av=1.0, ax=1.0 / Delta, model="UV", K=K, alpha=M / N,
        damping=0.5, device=device)
    eye = torch.eye(K, dtype=torch.float64)
    q_u, q_v = eye - mse_u.cpu(), eye - mse_v.cpu()
    return float((K - torch.trace(q_u @ q_v)) / N)


def main(argv=None):
    p = _cli.parser(__doc__, big="M = N = 512, Delta 0.1 added")
    p.add_argument("--seeds", type=int, default=4)
    args = p.parse_args(argv)
    device = _cli.device(args)
    M = N = 512 if args.big else 128
    rows = []
    for Delta in deltas(args.big):
        mse_x, vz_u = mse_empirical(Delta, M, N, args.seeds, device)
        pred = mse_se(Delta, M, N, device)
        rows.append((Delta, mse_x, pred, vz_u))
        print(f"Delta={Delta:4.2f}  mse_x={mse_x:.3e}  "
              f"SE pred={pred:.3e}  ratio={mse_x / pred:5.2f}")
    csv = os.path.join(_cli.out_dir(args, "low_rank"),
                       "matrix_factorization_ep_vs_se.csv")
    np.savetxt(csv, np.asarray(rows), delimiter=",",
               header="delta,mse_x_emp,mse_x_se,vz_u")
    print(f"wrote {csv}")
    return rows


if __name__ == "__main__":
    main()
