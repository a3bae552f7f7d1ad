"""The sparse, low_rank and vae_prior gallery scripts end to end through
``main(["--device", "cpu", "--out", dir])`` at their default sizes (these
are small) or with fewer seeds: each writes its file with the JAX script's
columns or keys and finite values, and the task-level checks of the JAX
scripts hold (EP beats the noise floor, the blurred observation, Gaussian
shrinkage).
"""
import numpy as np
import pytest
import torch

from tramp_tpu_torch.examples.sparse import (
    sparse_gradient, sparse_fft, image_deconvolution, image_denoising)
from tramp_tpu_torch.examples.low_rank import matrix_factorization
from tramp_tpu_torch.examples.vae_prior import inpainting

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def test_sparse_gradient_main(tmp_path):
    out = sparse_gradient.main(CPU + ["--out", str(tmp_path)])
    path = tmp_path / "sparse_gradient_recovery.csv"
    assert path.read_text().splitlines()[0] == "# x_true,x_ep"
    data = np.loadtxt(path, delimiter=",")
    assert data.shape == (128, 2) and np.isfinite(data).all()
    assert out["mse"] < 0.1 * out["x0"].var()


def test_sparse_fft_main(tmp_path):
    pytest.importorskip("matplotlib")
    mse = sparse_fft.main(CPU + ["--out", str(tmp_path), "--plot"])
    assert mse["x"] < 0.1 and np.isfinite(mse["z"])
    assert (tmp_path / "sparse_fft.png").stat().st_size > 0


def test_image_deconvolution_main(tmp_path):
    out = image_deconvolution.main(CPU + ["--out", str(tmp_path)])
    saved = np.load(tmp_path / "deconvolution.npz")
    assert sorted(saved.files) == ["r", "x0", "y"]
    assert saved["r"].shape == (32, 32) and np.isfinite(saved["r"]).all()
    assert out["mse_ep"] < out["mse_blurred"]


@pytest.mark.parametrize("tv", [False, True], ids=["sparse", "tv"])
def test_image_denoising_main(tv):
    out = image_denoising.main(CPU + (["--tv"] if tv else []))
    assert out["mse"] < out["mse_gauss"] < out["mse_noisy"]


def test_matrix_factorization_main(tmp_path):
    rows = matrix_factorization.main(CPU + ["--out", str(tmp_path),
                                            "--seeds", "1"])
    path = tmp_path / "matrix_factorization_ep_vs_se.csv"
    assert path.read_text().splitlines()[0] == \
        "# delta,mse_x_emp,mse_x_se,vz_u"
    data = np.loadtxt(path, delimiter=",")
    assert np.allclose(data, np.asarray(rows), rtol=1e-15)
    assert data.shape == (4, 4) and np.isfinite(data).all()


def test_inpainting_main(tmp_path, capsys):
    "The random decoder stands in for the absent weights, and says so."
    out = inpainting.main(CPU + ["--out", str(tmp_path), "--weights",
                                 str(tmp_path / "absent.h5")])
    assert "using random decoder weights" in capsys.readouterr().out
    saved = np.load(tmp_path / "inpainting.npz")
    assert sorted(saved.files) == ["band", "r", "x0", "y_obs"]
    assert saved["band"].sum() == int(0.25 * 784)
    assert saved["y_obs"].shape == (784 - int(0.25 * 784),)
    assert np.isfinite(saved["r"]).all()
    assert np.isfinite([out["mse_band"], out["mse_zero"]]).all()
