"""VAE generative prior: a trained VAE decoder as a multi-layer prior block
for inpainting and denoising. Counterpart of tramp_tpu/models/vae_prior.py
(reference examples/vae_prior/plot_vae.py:100-160).

Weights come from an .h5 file with a Keras-style 'decoder' group; h5py is
imported by the loader alone, so the module imports without it."""
import numpy as np

from ..channels import (
    LinearChannel, BiasChannel, LeakyReluChannel, HardTanhChannel,
    ReshapeChannel,
)
from ..priors import GaussianPrior
from ..variables import SISOVariable as V


def load_vae_decoder_weights(path):
    "Load (biases, weights) from a Keras VAE decoder .h5 file."
    import h5py
    with h5py.File(path, "r") as file:
        decoder = file["decoder"]
        layers = [decoder[key] for key in list(decoder.keys())]
        weights = [np.asarray(layer["kernel:0"][()]).T for layer in layers]
        try:
            biases = [np.asarray(layer["bias:0"][()]) for layer in layers]
        except KeyError:
            biases = []
    return biases, weights


def vae_prior_block(weights, biases, latent_dim=20, output_shape=784,
                    device=None, dtype=None):
    """Decoder-as-prior DAG block:
    N(0,1)^D @ z0 @ W1 + b1 @ leaky-relu(0) @ W2 + b2 @ hard-tanh @ reshape.
    Reference plot_vae.py:125-136 (id '20_relu_400_sigmoid_784_bias').
    ``device`` and ``dtype`` are those of the block's arrays (None: the
    first card, the default dtype)."""
    W1, W2 = weights
    b1, b2 = biases
    D = latent_dim
    if W1.shape[1] != D:
        raise ValueError(f"W1 has {W1.shape[1]} columns, latent_dim {D}")
    N = W2.shape[0]
    kw = dict(device=device, dtype=dtype)
    return (
        GaussianPrior(size=D, **kw) @ V(id="z_0") @
        LinearChannel(W1, name="W_1", **kw) @ V(id="Wz_1") @
        BiasChannel(b1, **kw) @ V(id="b_1") @
        LeakyReluChannel(0.0) @ V(id="z_1") @
        LinearChannel(W2, name="W_2", **kw) @ V(id="Wz_2") @
        BiasChannel(b2, **kw) @ V(id="b_2") @
        HardTanhChannel() @ V(id="z_2") @
        ReshapeChannel(prev_shape=N, next_shape=output_shape)
    )


def vae_prior_from_h5(path, latent_dim=20, output_shape=784, device=None,
                      dtype=None):
    biases, weights = load_vae_decoder_weights(path)
    return vae_prior_block(weights, biases, latent_dim=latent_dim,
                           output_shape=output_shape, device=device,
                           dtype=dtype)
