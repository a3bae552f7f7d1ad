"""Sparse FFT: recover a signal sparse in Fourier space from noisy samples.

Counterpart of examples/sparse/sparse_fft.py (reference analog:
examples/sparse/plot_sparse_fft.py:21-116).

Teacher: x(t) = cos(t) + sin(2t) sampled on N points, y = x + noise.
Student: a Gaussian prior on x feeding both a Gaussian likelihood on y and
a DFT channel whose output z carries a Gauss-Bernoulli (sparse) prior: a
SIMO variable x and a MI leaf z, exactly the reference's tree. Float64, as
the JAX script runs with x64; the noise comes from a ``torch.Generator``.
``--plot`` writes sparse_fft.png to ``--out``.

Run: python -m tramp_tpu_torch.examples.sparse.sparse_fft [--device cpu]
[--out DIR] [--plot]
"""
import os

import numpy as np
import torch

from tramp_tpu_torch.variables import (
    SISOVariable as V, SILeafVariable as O, SIMOVariable, MILeafVariable)
from tramp_tpu_torch.channels import DFTChannel, GaussianChannel
from tramp_tpu_torch.priors import GaussBernoulliPrior, GaussianPrior
from tramp_tpu_torch.algos import EarlyStoppingEP
from tramp_tpu_torch.experiments import TeacherStudentScenario
from tramp_tpu_torch.examples import _cli

F64 = torch.float64


class SparseFFTTeacher:
    "Deterministic signal + Gaussian observation noise (reference l:21-42)."

    def __init__(self, N, noise_var, device):
        self.t = np.linspace(-2 * np.pi, 2 * np.pi, N, endpoint=False)
        self.noise_var = noise_var
        self.N = N
        self.device = device

    def sample(self, generator=None):
        "A torch.Generator, or None for the generator seeded with 0."
        if generator is None:
            generator = _cli.generator(self.device, 0)
        x = torch.as_tensor(np.cos(self.t) + np.sin(2 * self.t),
                            device=self.device, dtype=F64)
        z = DFTChannel(real=True).sample(None, x)
        noise = torch.randn(self.N, generator=generator, device=self.device,
                            dtype=F64)
        y = x + np.sqrt(self.noise_var) * noise
        return {"x": x, "z": z, "y": y}


def build_student(N, prior_var, rho, fft_var, noise_var, device):
    kw = dict(device=device, dtype=F64)
    return (
        GaussianPrior(size=(N,), var=prior_var, **kw) @
        SIMOVariable(id="x", n_next=2) @ (
            GaussianChannel(var=noise_var) @ O("y") + (
                DFTChannel(real=True) +
                GaussBernoulliPrior(size=(2, N), var=fft_var, rho=rho, **kw)
            ) @
            MILeafVariable(id="z", n_prev=2)
        )
    ).to_model()


def run(device, N=100, rho=0.02, noise_var=0.1, seed=1, prior_var=1.0,
        fft_var=18.75):
    "The scenario after EP; reference parameters (plot_sparse_fft.py:97-98)."
    teacher = SparseFFTTeacher(N, noise_var, device)
    student = build_student(N, prior_var, rho, fft_var, noise_var, device)
    scenario = TeacherStudentScenario(teacher, student, x_ids=["x", "z"])
    scenario.setup(seed=seed)
    scenario.run_ep(max_iter=1000, damping=0.1,
                    callback=EarlyStoppingEP(tol=1e-2))
    return scenario


def main(argv=None):
    args = _cli.parser(__doc__, plot=True).parse_args(argv)
    device = _cli.device(args)
    noise_var = 0.1
    scenario = run(device, noise_var=noise_var)
    mse = {k: float(torch.mean((scenario.x_pred[k] - scenario.x_true[k])
                               ** 2)) for k in ("x", "z")}
    print(f"mse(x)={mse['x']:.4f} mse(z)={mse['z']:.4f} "
          f"(noise var {noise_var}; EP should beat the noise floor on x)")
    assert mse["x"] < noise_var, "sparse-FFT denoising should beat raw noise"
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        out = _cli.out_dir(args, "sparse")
        cpu = {k: v.cpu().numpy() for k, v in scenario.x_true.items()}
        pred = {k: v.cpu().numpy() for k, v in scenario.x_pred.items()}
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        axes[0].plot(scenario.observations["y"].cpu().numpy(), "C2x",
                     label="y")
        axes[1].plot(cpu["x"], label="x*")
        axes[1].plot(pred["x"], label="x hat")
        axes[2].stem(cpu["z"][1], markerfmt="C0o", linefmt="C0-")
        axes[2].stem(pred["z"][1], markerfmt="C1x", linefmt="C1:")
        axes[2].set_xlim(0, 25)
        for ax in axes[:2]:
            ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out, "sparse_fft.png"), dpi=120)
        print(f"wrote {out}/sparse_fft.png")
    return mse


if __name__ == "__main__":
    main()
