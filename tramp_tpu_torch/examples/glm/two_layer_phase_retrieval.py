"""Two-layer phase retrieval: the modulus channel mid-graph.

    x (complex) -> W1 (complex) -> |.| -> W2 (real) -> + noise -> y

Counterpart of examples/glm/two_layer_phase_retrieval.py. The reference
can only put its ModulusChannel at a leaf (its posteriors raise
NotImplementedError, tramp/channels/activation/modulus_channel.py:29-37);
here its posteriors come from the radial quadrature of the
phase-integrated tilted density (tramp_tpu_torch/channels/modulus_channel.py),
so it sits anywhere in the tree. EP recovers x up to a global phase.
Float32, as the JAX script (which does not enable x64). Writes a CSV of
(N, M1, M2, phase_mse, v).

Run: python -m tramp_tpu_torch.examples.glm.two_layer_phase_retrieval
[--big] [--device cpu] [--out DIR]
"""
import math
import os

import numpy as np
import torch

import tramp_tpu_torch as tt
from tramp_tpu_torch.priors import GaussianPrior
from tramp_tpu_torch.channels import (
    ComplexLinearChannel, LinearChannel, ModulusChannel, GaussianChannel)
from tramp_tpu_torch.examples import _cli


def build(N, M1, M2, noise_var, generator, device, dtype=torch.float32):
    "The teacher; W1 and W2 drawn from ``generator``."
    kw = dict(generator=generator, device=device, dtype=dtype)
    W1 = torch.complex(torch.randn((M1, N), **kw),
                       torch.randn((M1, N), **kw)) / math.sqrt(2 * N)
    W2 = torch.randn((M2, M1), **kw) / math.sqrt(M1)
    return (
        GaussianPrior(size=(2, N), mean=0.3, device=device, dtype=dtype)
        @ tt.V(id="x") @ ComplexLinearChannel(W1, name="W_1") @ tt.V(id="z")
        @ ModulusChannel() @ tt.V(id="a")
        @ LinearChannel(W2, name="W_2") @ tt.V(id="u")
        @ GaussianChannel(var=noise_var) @ tt.O(id="y")
    ).to_model()


def phase_mse(xhat, x0):
    "MSE up to a global phase (reference algos/metrics.py phase_mse)."
    xh = xhat[0] + 1j * xhat[1]
    x = x0[0] + 1j * x0[1]
    ip = np.vdot(xh.ravel(), x.ravel())
    phase = ip / max(abs(ip), 1e-30)
    return float(np.mean(np.abs(x - phase * xh) ** 2) / 2)


def run(N, device):
    "(phase_mse, tau_x, v) of EP on the size-N problem."
    M1 = M2 = 3 * N
    teacher = build(N, M1, M2, 1e-4, _cli.generator(device, 0), device)
    sample = teacher.sample(_cli.generator(device, 1))
    student = teacher.to_observed({"y": sample["y"]})
    ep = tt.ExpectationPropagation(student)
    ep.iterate(max_iter=300, damping=0.3)
    d = ep.get_variable_data("x")
    x0 = sample["x"].double().cpu().numpy()
    mse = phase_mse(d["r"].double().cpu().numpy(), x0)
    return mse, float(np.mean(x0 ** 2)), _cli.mean(d["v"])


def sizes(big):
    "N of the default or the --big run."
    return 256 if big else 64


def main(argv=None):
    args = _cli.parser(__doc__, big="N = 256").parse_args(argv)
    device = _cli.device(args)
    N = sizes(args.big)
    M1, M2 = 3 * N, 3 * N
    mse, tau, v = run(N, device)
    print(f"N={N} M1={M1} M2={M2}: phase-mse={mse:.2e} "
          f"(tau_x={tau:.3f}, v={v:.2e})")
    out = os.path.join(_cli.out_dir(args, "glm"), "two_layer_pr.csv")
    with open(out, "w") as f:
        f.write("N,M1,M2,phase_mse,v\n")
        f.write(f"{N},{M1},{M2},{mse},{v}\n")
    print(f"wrote {out}")
    return dict(N=N, M1=M1, M2=M2, phase_mse=mse, v=v, tau_x=tau)


if __name__ == "__main__":
    main()
