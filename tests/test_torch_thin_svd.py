"""The thin-SVD linear channels against a dense oracle, the port's
counterpart of the JAX package's tests/test_thin_svd.py (ROADMAP Queue 3,
parity gap 3).

``LinearChannel`` keeps only the thin factors U (Nx, k), V (Nz, k), k =
min(Nx, Nz); the modes beyond k (resolvent 1/az) come back through the
projector identity V_perp V_perp^T = I - V V^T. Its means and
log-partition are held against a direct solve of the Gaussian posterior in
float64 for the wide, tall and square aspects, a precomputed ``svd=`` with
full matrices is sliced to the thin factors for both aspects, and the
port's batched layouts (a trailing K axis, ``W @ Z``, and lanes first) give
each column's or lane's single result. ``ComplexLinearChannel`` likewise,
with complex messages packed as re/im planes.
"""
import numpy as np
import pytest
import torch

from tramp_tpu_torch.channels import LinearChannel, ComplexLinearChannel
from tramp_tpu_torch.utils.misc import complex2array, array2complex

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)


def t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _dense_oracle(W, az, bz, ax, bx):
    "rz, rx and logZ of p(z) ∝ exp(-az|z|²/2 + bz·z - ax|Wz|²/2 + bx·Wz)."
    Nz = W.shape[1]
    A = az * np.eye(Nz) + ax * W.T @ W
    b = np.asarray(bz + W.T @ bx)
    rz = np.linalg.solve(A, b)
    sign, logdet = np.linalg.slogdet(A)
    assert sign > 0
    logZ = 0.5 * b @ rz + 0.5 * (Nz * np.log(2 * np.pi) - logdet)
    return rz, W @ rz, logZ


@pytest.mark.parametrize("shape", [(30, 60), (60, 30), (40, 40)])
def test_thin_means_match_dense_oracle(shape):
    Nx, Nz = shape
    rng = np.random.default_rng(0)
    W = rng.normal(size=(Nx, Nz)) / np.sqrt(Nz)
    lin = LinearChannel(W, **F64)
    k = min(Nx, Nz)
    assert lin.U.shape == (Nx, k) and lin.V.shape == (Nz, k)
    az, ax = 0.7, 1.3
    bz, bx = rng.normal(size=Nz), rng.normal(size=Nx)
    rz_o, rx_o, logZ_o = _dense_oracle(W, az, bz, ax, bx)
    args = (t(az), t(bz), t(ax), t(bx))
    np.testing.assert_allclose(lin.compute_backward_mean(*args).numpy(),
                               rz_o, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(lin.compute_forward_mean(*args).numpy(),
                               rx_o, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(lin.compute_log_partition(*args)),
                               logZ_o, rtol=1e-12)


@pytest.mark.parametrize("shape", [(30, 60), (60, 30)])
def test_thin_means_trailing_axis_and_lanes(shape):
    """A trailing K axis ((n, K) variables, W @ Z) and lanes ((B, n)
    messages with (B, 1) precisions) give each column's and each lane's
    single result."""
    Nx, Nz = shape
    rng = np.random.default_rng(1)
    W = rng.normal(size=(Nx, Nz)) / np.sqrt(Nz)
    lin = LinearChannel(W, **F64)
    az, ax, B = 0.4, 2.1, 3
    bzB, bxB = rng.normal(size=(Nz, B)), rng.normal(size=(Nx, B))
    rzK = lin.compute_backward_mean(t(az), t(bzB), t(ax), t(bxB))
    rxK = lin.compute_forward_mean(t(az), t(bzB), t(ax), t(bxB))
    aL, xL = t(np.full((B, 1), az)), t(np.full((B, 1), ax))
    rzL = lin.compute_backward_mean(aL, t(bzB.T), xL, t(bxB.T))
    rxL = lin.compute_forward_mean(aL, t(bzB.T), xL, t(bxB.T))
    assert rzK.shape == (Nz, B) and rzL.shape == (B, Nz)
    for j in range(B):
        args = (t(az), t(bzB[:, j]), t(ax), t(bxB[:, j]))
        rz = lin.compute_backward_mean(*args).numpy()
        rx = lin.compute_forward_mean(*args).numpy()
        for got, want in ((rzK[:, j], rz), (rxK[:, j], rx), (rzL[j], rz),
                          (rxL[j], rx)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=1e-14)


def _full_svd_channel(W):
    U, s, Vt = np.linalg.svd(W, full_matrices=True)
    return LinearChannel(W, svd=(U, s, Vt), **F64)


def test_precomputed_full_svd_is_sliced():
    "svd=(U, s, Vt) with full matrices is accepted and thinned."
    rng = np.random.default_rng(2)
    Nx, Nz = 20, 50
    W = rng.normal(size=(Nx, Nz)) / np.sqrt(Nz)
    lin, thin = _full_svd_channel(W), LinearChannel(W, **F64)
    args = (t(1.1), t(rng.normal(size=Nz)), t(0.9), t(rng.normal(size=Nx)))
    np.testing.assert_allclose(lin.compute_backward_mean(*args).numpy(),
                               thin.compute_backward_mean(*args).numpy(),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", [(30, 60), (60, 30), (40, 40)])
def test_precomputed_full_svd_all_aspects(shape):
    """The svd= slicing for every aspect: wide (U square, Vt sliced), tall
    (U sliced to (Nx, k), Vt square) and square, against the dense oracle
    too."""
    Nx, Nz = shape
    rng = np.random.default_rng(3)
    W = rng.normal(size=(Nx, Nz)) / np.sqrt(Nz)
    lin, thin = _full_svd_channel(W), LinearChannel(W, **F64)
    k = min(Nx, Nz)
    assert lin.U.shape == (Nx, k) and lin.V.shape == (Nz, k)
    assert lin.s.shape == (k,) and lin.spectrum.shape == (Nz,)
    az, ax = 1.1, 0.9
    bz, bx = rng.normal(size=Nz), rng.normal(size=Nx)
    rz_o, rx_o, _ = _dense_oracle(W, az, bz, ax, bx)
    args = (t(az), t(bz), t(ax), t(bx))
    for fn, oracle in (("compute_backward_mean", rz_o),
                       ("compute_forward_mean", rx_o)):
        got = getattr(lin, fn)(*args).numpy()
        np.testing.assert_allclose(got, getattr(thin, fn)(*args).numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=fn)
        np.testing.assert_allclose(got, oracle, rtol=1e-10, atol=1e-12,
                                   err_msg=fn)


# -- ComplexLinearChannel: wide, tall and square against a dense oracle ----

def _dense_complex_oracle(W, az, bz, ax, bx):
    "Complex Gaussian posterior: A rz = bz + W^H bx, A = az I + ax W^H W."
    Nz = W.shape[1]
    A = az * np.eye(Nz) + ax * W.conj().T @ W
    rz = np.linalg.solve(A, bz + W.conj().T @ bx)
    return rz, W @ rz


def _complex_case(shape, seed):
    Nx, Nz = shape
    rng = np.random.default_rng(seed)
    W = (rng.normal(size=(Nx, Nz))
         + 1j * rng.normal(size=(Nx, Nz))) / np.sqrt(2 * Nz)
    bz = rng.normal(size=Nz) + 1j * rng.normal(size=Nz)
    bx = rng.normal(size=Nx) + 1j * rng.normal(size=Nx)
    return W, bz, bx


def _packed(c):
    return complex2array(torch.as_tensor(c))


@pytest.mark.parametrize("shape", [(5, 9), (9, 5), (6, 6)])
def test_complex_thin_means_match_dense_oracle(shape):
    Nx, Nz = shape
    W, bz, bx = _complex_case(shape, 4)
    ch = ComplexLinearChannel(W, **F64)
    k = min(Nx, Nz)
    assert ch.U.shape == (Nx, k) and ch.V.shape == (Nz, k)
    az, ax = 0.8, 1.6
    rz_o, rx_o = _dense_complex_oracle(W, az, bz, ax, bx)
    args = (t(az), _packed(bz), t(ax), _packed(bx))
    rz = array2complex(ch.compute_backward_mean(*args)).numpy()
    rx = array2complex(ch.compute_forward_mean(*args)).numpy()
    np.testing.assert_allclose(rz, rz_o, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(rx, rx_o, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("shape", [(5, 9), (9, 5)])
def test_complex_precomputed_svd_is_sliced(shape):
    "ComplexLinearChannel svd= slicing (Vh[:k], U[:, :k]), both aspects."
    Nx, Nz = shape
    W, bz, bx = _complex_case(shape, 5)
    U, s, Vh = np.linalg.svd(W, full_matrices=True)
    ch = ComplexLinearChannel(W, svd=(U, s, Vh), **F64)
    thin = ComplexLinearChannel(W, **F64)
    k = min(Nx, Nz)
    assert ch.U.shape == (Nx, k) and ch.V.shape == (Nz, k)
    args = (t(1.2), _packed(bz), t(0.5), _packed(bx))
    rz_o, rx_o = _dense_complex_oracle(W, 1.2, bz, 0.5, bx)
    for fn, oracle in (("compute_backward_mean", rz_o),
                       ("compute_forward_mean", rx_o)):
        got = getattr(ch, fn)(*args)
        np.testing.assert_allclose(got.numpy(),
                                   getattr(thin, fn)(*args).numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=fn)
        np.testing.assert_allclose(array2complex(got).numpy(), oracle,
                                   rtol=1e-10, atol=1e-12, err_msg=fn)
