"""Inpainting with a VAE decoder as generative prior.

Counterpart of examples/vae_prior/inpainting.py (reference analog:
examples/vae_prior/plot_vae.py:100-160, whose MNIST decoder weights the
upstream project commits). The observation erases a band of pixels; the
decoder prior fills them back.

It uses the upstream decoder weights when they are present at
``--weights`` (by default the upstream project's path,
examples/vae_prior/weights_vae/mnist/..., in the checkout), else random
weights of the same architecture from ``np.random.RandomState(0)``, as the
JAX script does (demo only), and says which. EP on this model has no fixed
point: what it gives is the band's MSE beside the fill-zero MSE. Float64,
as the JAX script runs with x64. Writes inpainting.npz (x0, y_obs, r,
band).

Run: python -m tramp_tpu_torch.examples.vae_prior.inpainting
[--weights H5] [--device cpu] [--out DIR]
"""
import os

import numpy as np
import torch

from tramp_tpu_torch.models.vae_prior import (
    vae_prior_block, vae_prior_from_h5)
from tramp_tpu_torch.variables import SISOVariable as V, SILeafVariable as O
from tramp_tpu_torch.channels import GaussianChannel, LinearChannel
from tramp_tpu_torch.likelihoods import GaussianLikelihood
from tramp_tpu_torch.algos import ExpectationPropagation
from tramp_tpu_torch.algos.initial_conditions import NoisyInit
from tramp_tpu_torch.examples import _cli

F64 = torch.float64
REF_H5 = os.path.join(_cli.ROOT, "examples", "vae_prior", "weights_vae",
                      "mnist", "vae_mnist_20_relu_400_sigmoid_784_bias.h5")


def get_block(path, device):
    if os.path.exists(path):
        print(f"using reference weights {path}")
        return vae_prior_from_h5(path, device=device, dtype=F64)
    print("reference weights not found: using random decoder weights")
    rng = np.random.RandomState(0)
    weights = [rng.randn(400, 20) / np.sqrt(20),
               rng.randn(784, 400) / np.sqrt(400)]
    biases = [rng.randn(400) * 0.01, rng.randn(784) * 0.01]
    return vae_prior_block(weights, biases, device=device, dtype=F64)


def main(argv=None):
    p = _cli.parser(__doc__)
    p.add_argument("--weights", default=REF_H5,
                   help="the upstream decoder's .h5 weights")
    args = p.parse_args(argv)
    device = _cli.device(args)
    block = get_block(args.weights, device)
    noise_var = 0.01

    teacher = (block @ V(id="x") @
               GaussianChannel(var=noise_var) @ O(id="y")).to_model()
    sample = teacher.sample(_cli.generator(device, 4))
    x0 = sample["x"].cpu().numpy()

    # erase a 25% middle band; observed pixels are selected by a row-deleted
    # identity sensing matrix (reference plot_vae.py:186-227, 448-450)
    band = np.zeros(784, bool)
    n_rem = int(0.25 * 784)
    band[392 - n_rem // 2: 392 - n_rem // 2 + n_rem] = True
    F_obs = np.eye(784)[~band]
    y_obs = sample["y"].cpu().numpy()[~band]

    kw = dict(device=device, dtype=F64)
    student = (block @ V(id="x") @
               LinearChannel(F_obs, name="F", **kw) @ V(id="z") @
               GaussianLikelihood(y=torch.as_tensor(y_obs, **kw),
                                  var=noise_var)
               ).to_model()

    # NoisyInit breaks the deep decoder's symmetries; mse is reported
    # sign-symmetrically, both as in the reference (plot_vae.py:303-334).
    # Like the reference, EP only partially fills the band.
    ep = ExpectationPropagation(student)
    ep.iterate(max_iter=200, damping=0.5, initializer=NoisyInit())
    r = ep.get_variable_data("x")["r"].cpu().numpy()

    mse_band = min(float(np.mean((r[band] - x0[band]) ** 2)),
                   float(np.mean((r[band] + x0[band]) ** 2)))
    mse_zero = float(np.mean(x0[band] ** 2))
    print(f"inpainting mse on erased band: {mse_band:.4f} "
          f"(trivial fill-zero mse {mse_zero:.4f})")
    out = os.path.join(_cli.out_dir(args, "vae_prior"), "inpainting.npz")
    np.savez(out, x0=x0, y_obs=y_obs, r=r, band=band)
    print(f"wrote {out}")
    return dict(mse_band=mse_band, mse_zero=mse_zero, n_iter=ep.n_iter)


if __name__ == "__main__":
    main()
