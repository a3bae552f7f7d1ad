"""Image denoising with a sparse-gradient (or TV, MAP-L21) prior.

Counterpart of examples/sparse/image_denoising.py (reference analog:
examples/sparse/plot_raccoon_denoise.py: a sparse-gradient teacher/student
on the raccoon image; here a synthetic piecewise-constant image, so that
the gallery runs offline, like image_deconvolution).

Model: x has a Gaussian prior and its gradient x' = grad(x) carries a
Gauss-Bernoulli (sparse) or MAP-L21 (TV) prior; y = x + noise is observed.
The tree is the reference's: a SIMO x feeding the Gaussian likelihood and
the gradient branch, merged at the MI leaf x'. The image and the noise
come from ``np.random.RandomState(0)``, as in the JAX script; float64, as
it runs with x64. It writes no file.

Run: python -m tramp_tpu_torch.examples.sparse.image_denoising [--big]
[--tv] [--device cpu]
"""
import numpy as np
import torch

from tramp_tpu_torch.variables import (
    SIMOVariable, MILeafVariable, SILeafVariable as O)
from tramp_tpu_torch.priors import (
    GaussianPrior, GaussBernoulliPrior, MAP_L21NormPrior)
from tramp_tpu_torch.channels import GradientChannel, GaussianChannel
from tramp_tpu_torch.algos import (
    ExpectationPropagation, EarlyStoppingEP, ConstantInit)
from tramp_tpu_torch.examples import _cli
from tramp_tpu_torch.examples.sparse.image_deconvolution import make_image


def build_student(shape, y, noise_var, grad_prior, device):
    kw = dict(device=device, dtype=torch.float64)
    return (
        GaussianPrior(size=shape, **kw) @
        SIMOVariable(id="x", n_next=2) @ (
            GaussianChannel(var=noise_var) @ O("y") + (
                GradientChannel(shape=shape, **kw) + grad_prior
            ) @ MILeafVariable(id="x'", n_prev=2)
        )
    ).to_model().to_observed({"y": torch.as_tensor(y, **kw)})


def run(H, tv, device, noise_var=0.1):
    "(mse of y, denoised mse) on the H x H image."
    W = H
    kw = dict(device=device, dtype=torch.float64)
    rng = np.random.RandomState(0)
    x0 = make_image(H, W, rng)
    y = x0 + np.sqrt(noise_var) * rng.randn(H, W)
    # gradient-prior hyperparameters matched to the teacher's gradient
    # statistics (as the reference tunes them to the raccoon's histograms,
    # plot_raccoon_denoise.py "hyperparam for grad x")
    g = np.stack(np.gradient(x0))
    nz = np.abs(g) > 0.05
    grad_shape = (2, H, W)
    if tv:
        # gamma=1 as the reference (plot_raccoon_denoise.py:140)
        grad_prior = MAP_L21NormPrior(size=grad_shape, gamma=1.0, axis=0,
                                      **kw)
    else:
        grad_prior = GaussBernoulliPrior(
            size=grad_shape, rho=float(nz.mean()), var=float(g[nz].var()),
            **kw)
    student = build_student((H, W), y, noise_var, grad_prior, device)
    ep = ExpectationPropagation(student)
    if tv:
        # a = b = 1 init: EP on the MAP-L21 denoiser diverges from zero
        # init (reference plot_raccoon_denoise.py: "We need to set initial
        # conditions a = b = 1")
        ep.iterate(max_iter=100, damping=0.0,
                   initializer=ConstantInit(a=1, b=1))
    else:
        ep.iterate(max_iter=200, damping=0.1, callback=EarlyStoppingEP())
    x_hat = ep.get_variable_data("x")["r"].cpu().numpy()
    return float(np.mean((y - x0) ** 2)), float(np.mean((x_hat - x0) ** 2))


def main(argv=None):
    p = _cli.parser(__doc__, big="64 x 64")
    p.add_argument("--tv", action="store_true",
                   help="MAP-L21 (TV) gradient prior instead of "
                        "GaussBernoulli")
    args = p.parse_args(argv)
    device = _cli.device(args)
    H = 64 if args.big else 32
    noise_var = 0.1
    mse_y, mse = run(H, args.tv, device, noise_var)
    # pure-Gaussian-prior baseline: shrinkage mse ~ noise/(1+noise)
    mse_gauss = noise_var / (1 + noise_var)
    print(f"noisy mse={mse_y:.4f} gaussian-prior mse~{mse_gauss:.4f} -> "
          f"denoised mse={mse:.4f} "
          f"({'TV' if args.tv else 'sparse-gradient'} prior)")
    assert mse < mse_gauss, "edge prior should beat plain Gaussian shrinkage"
    return dict(mse_noisy=mse_y, mse_gauss=mse_gauss, mse=mse)


if __name__ == "__main__":
    main()
