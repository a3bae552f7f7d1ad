"""The VAE prior (BASELINE config 4's model), tramp_tpu_torch against
tramp_tpu, float64 on the CPU, with the synthetic 20-400-784 decoder of
tests/test_vae_prior.py:20-27 (the reference's MNIST weights are not in the
repository): N(0, 1)^20 -> W1 -> + b1 -> leaky-relu(0) -> W2 -> + b2 ->
hard-tanh -> reshape, observed through Gaussian noise.

EP on this model has no fixed point (bench.py:632-637), so it is held as a
snapshot: 30 sweeps at damping 0.3 through both engines, every variable's
r and v at rtol 1e-8 and equal n_iter. Then the denoising bound of
tests/test_vae_prior.py:29-44 on the port's own teacher; the block's
shapes and ranges; and the loader, whose h5py import waits for a file.
"""
import numpy as np
import pytest
import torch

import tramp_tpu as jt
from tramp_tpu.channels import GaussianChannel as JGaussianChannel
from tramp_tpu.models.vae_prior import vae_prior_block as j_vae_prior_block

import tramp_tpu_torch as tt
from tramp_tpu_torch.channels import (
    BiasChannel, GaussianChannel, HardTanhChannel, LeakyReluChannel,
    ReshapeChannel)
from tramp_tpu_torch.models import vae_prior_block

from torch_parity import assert_close, port_model

F64 = torch.float64
NOISE_VAR = 0.05


def _weights():
    "tests/test_vae_prior.py:20-27, RandomState(0)."
    rng = np.random.RandomState(0)
    weights = [rng.randn(400, 20) / np.sqrt(20),
               rng.randn(784, 400) / np.sqrt(400)]
    biases = [rng.randn(400) * 0.01, rng.randn(784) * 0.01]
    return weights, biases


def test_vae_prior_snapshot_matches_jax():
    import jax
    weights, biases = _weights()
    teacher = (j_vae_prior_block(weights, biases) @ jt.V(id="x")
               @ JGaussianChannel(var=NOISE_VAR) @ jt.O(id="y")).to_model()
    sample = teacher.sample(jax.random.PRNGKey(0))
    j_student = teacher.to_observed({"y": sample["y"]})
    student = port_model(j_student)
    kinds = [type(f) for f in student.factors]
    assert kinds.count(BiasChannel) == 2 and ReshapeChannel in kinds
    kw = dict(max_iter=30, damping=0.3, tol=0.0)
    ep = tt.ExpectationPropagation(student).iterate(**kw)
    j_ep = jt.ExpectationPropagation(j_student)
    j_ep.iterate(**kw)
    assert ep.n_iter == j_ep.n_iter
    for id, d in j_ep.get_variables_data().items():
        assert_close(ep.get_variable_data(id)["r"], d["r"], 1e-8, what=id)
        assert_close(ep.get_variable_data(id)["v"], d["v"], 1e-8, what=id)


def test_vae_prior_denoising():
    weights, biases = _weights()
    block = vae_prior_block(weights, biases, device="cpu", dtype=F64)
    teacher = (block @ tt.V(id="x") @ GaussianChannel(var=NOISE_VAR)
               @ tt.O(id="y")).to_model()
    sample = teacher.sample(torch.Generator().manual_seed(0))
    assert sample["x"].shape == (784,)
    assert float(sample["z_2"].abs().max()) <= 1.0
    student = teacher.to_observed({"y": sample["y"]})
    ep = tt.ExpectationPropagation(student).iterate(max_iter=100, damping=0.3)
    r = ep.get_variable_data("x")["r"]
    mse = float(((r - sample["x"]) ** 2).mean())
    mse_y = float(((sample["y"] - sample["x"]) ** 2).mean())
    # the denoised estimate must beat the raw observation
    assert mse < 0.6 * mse_y, (mse, mse_y)


def test_vae_prior_block_shapes_and_reshape():
    weights, biases = _weights()
    block = vae_prior_block(weights, biases, output_shape=(28, 28),
                            device="cpu", dtype=F64)
    model = (block @ tt.O(id="x")).to_model()
    assert model.get_shapes()["x"] == (28, 28)
    assert model.get_shapes()["z_2"] == (784,)
    kinds = [type(f) for f in model.factors]
    assert LeakyReluChannel in kinds and HardTanhChannel in kinds
    x = model.sample(torch.Generator().manual_seed(1))["x"]
    assert x.shape == (28, 28) and float(x.abs().max()) <= 1.0
    with pytest.raises(ValueError, match="latent_dim"):
        vae_prior_block(weights, biases, latent_dim=10, device="cpu")


def test_vae_loader_imports_h5py_only_when_called(monkeypatch):
    "The module imports without h5py; the loader asks for it."
    import builtins
    import importlib
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("no h5py")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    from tramp_tpu_torch.models import vae_prior
    importlib.reload(vae_prior)
    with pytest.raises(ImportError, match="h5py"):
        vae_prior.load_vae_decoder_weights("absent.h5")
