"""Image deblurring: y = blur(x) + noise, Gaussian image prior.

Counterpart of examples/sparse/image_deconvolution.py (reference analog:
examples/sparse/plot_raccoon_deconv.py:60-82: Gaussian-prior deconvolution
of the blurred raccoon; here a synthetic standardized image, so that the
gallery runs offline). The image and the noise come from
``np.random.RandomState(0)``, as in the JAX script. Float64, as the JAX
script runs with x64. Writes deconvolution.npz (x0, y, r).

Run: python -m tramp_tpu_torch.examples.sparse.image_deconvolution [--big]
[--device cpu] [--out DIR]
"""
import os

import numpy as np
import torch

from tramp_tpu_torch.variables import SISOVariable as V, SILeafVariable as O
from tramp_tpu_torch.priors import GaussianPrior
from tramp_tpu_torch.channels import Blur2DChannel, GaussianChannel
from tramp_tpu_torch.algos import ExpectationPropagation
from tramp_tpu_torch.examples import _cli


def make_image(H, W, rng):
    "Piecewise-constant blocks, standardized like the reference raccoon."
    x = np.zeros((H, W))
    for _ in range(6):
        r0, c0 = rng.randint(0, H - 4), rng.randint(0, W - 4)
        r1, c1 = rng.randint(r0 + 2, H), rng.randint(c0 + 2, W)
        x[r0:r1, c0:c1] += rng.randn()
    return (x - x.mean()) / x.std()


def run(H, device, noise_var=0.1):
    "(x0, y, EP's posterior mean) on the H x H image."
    W = H
    kw = dict(device=device, dtype=torch.float64)
    rng = np.random.RandomState(0)
    x0 = make_image(H, W, rng)
    # reference: sigma=[10,10] on the 768x1024 raccoon; scale to image size
    sigma = H / 16.0
    blur = Blur2DChannel(sigma=(sigma, sigma), shape=(H, W), **kw)
    y = blur.sample(None, torch.as_tensor(x0, **kw)).cpu().numpy()
    y = y + np.sqrt(noise_var) * rng.randn(H, W)
    model = (
        GaussianPrior(size=(H, W), **kw) @ V(id="x") @
        Blur2DChannel(sigma=(sigma, sigma), shape=(H, W), **kw) @ V(id="z")
        @ GaussianChannel(var=noise_var) @ O(id="y")
    ).to_model().to_observed({"y": torch.as_tensor(y, **kw)})
    ep = ExpectationPropagation(model)
    ep.iterate(max_iter=100)
    return x0, y, ep.get_variable_data("x")["r"].cpu().numpy()


def main(argv=None):
    args = _cli.parser(__doc__, big="64 x 64").parse_args(argv)
    device = _cli.device(args)
    H = 64 if args.big else 32
    x0, y, r = run(H, device)
    mse_blurred = float(np.mean((y - x0) ** 2))
    mse_ep = float(np.mean((r - x0) ** 2))
    print(f"{H}x{H} deblur: observation mse={mse_blurred:.3e} "
          f"EP mse={mse_ep:.3e}")
    assert mse_ep < mse_blurred
    out = os.path.join(_cli.out_dir(args, "sparse"), "deconvolution.npz")
    np.savez(out, x0=x0, y=y, r=r)
    print(f"wrote {out}")
    return dict(mse_ep=mse_ep, mse_blurred=mse_blurred, x0=x0, y=y, r=r)


if __name__ == "__main__":
    main()
