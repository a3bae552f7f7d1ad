"""The structured real channels, tramp_tpu_torch against tramp_tpu, float64
on the CPU: ``ConvChannel`` and its filters (differential, laplacian, 1-D
and 2-D blur), ``GradientChannel``, ``DFTChannel`` and ``RotationChannel``,
and the ensembles that came with them.

First the counterparts of tests/test_structured_channels.py:25-110 and
:139-143 on the port (each channel against the dense operator it stands
for). Then every posterior, message, log-partition and SE method of each
channel against the JAX call at rtol 1e-10 (torch_parity.assert_close:
relative to each element, floored at rtol times the largest magnitude), on
1-D and 2-D shapes, ``real=False`` for conv and DFT, one instance and 3
lanes (messages ``(3,) + shape`` with precisions ``(3, 1, ...)``; SE
precisions ``(3, 1)``), each lane against the JAX call on that lane. The
JAX channels are built in the JAX package's FFT mode, whatever it is; the
port rebuilds the spectra from the filter (convert.py). The ensembles get
shapes and moments only: the two packages' RNGs differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tramp_tpu import channels as jch

from tramp_tpu_torch import convert, ensembles
from tramp_tpu_torch.channels import (
    Blur1DChannel, ConvChannel, DFTChannel, GradientChannel,
    LaplacianChannel, RotationChannel, get_channel)

from torch_parity import assert_close, describe_factor

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
RTOL = 1e-10


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _port(jax_factor):
    return convert.factor_from_description(describe_factor(jax_factor),
                                           **CPU)


# -- counterparts of tests/test_structured_channels.py -----------------------
def _dense(ch, shape):
    "The dense matrix of the channel's convolve map, column by column."
    n = int(np.prod(shape))
    cols = []
    for i in range(n):
        e = np.zeros(n)
        e[i] = 1
        cols.append(ch.convolve(_t(e.reshape(shape))).numpy().ravel())
    return np.stack(cols, axis=1)


def test_conv_channel_vs_dense():
    rng = np.random.RandomState(0)
    N = 16
    f = rng.randn(N)
    ch = ConvChannel(filter=f, **CPU)
    z = rng.randn(N)
    W = _dense(ch, (N,))
    np.testing.assert_allclose(W[:, 1], np.roll(W[:, 0], 1), atol=1e-10)
    np.testing.assert_allclose(ch.convolve(_t(z)).numpy(), W @ z, rtol=1e-8,
                               atol=1e-10)
    az, ax = 1.3, 0.7
    bz, bx = rng.randn(N), rng.randn(N)
    rz = ch.compute_backward_mean(_t(az), _t(bz), _t(ax), _t(bx)).numpy()
    want = np.linalg.solve(az * np.eye(N) + ax * W.T @ W, bz + W.T @ bx)
    np.testing.assert_allclose(rz, want, rtol=1e-8, atol=1e-10)
    s2 = np.abs(np.fft.fft(f)) ** 2
    n_eff = np.mean(s2 / (az / ax + s2))
    np.testing.assert_allclose(
        float(ch.compute_backward_variance(_t(az), _t(ax))), (1 - n_eff) / az,
        rtol=1e-10)


def test_gradient_channel_vs_dense():
    rng = np.random.RandomState(1)
    shape = (8, 6)
    ch = GradientChannel(shape=shape, **CPU)
    z = rng.randn(*shape)
    x = ch.convolve(_t(z)).numpy()
    assert x.shape == (2,) + shape
    np.testing.assert_allclose(x[0], np.roll(z, -1, axis=0) - z, atol=1e-10)
    np.testing.assert_allclose(x[1], np.roll(z, -1, axis=1) - z, atol=1e-10)
    az, ax = 0.8, 1.7
    bz, bx = rng.randn(*shape), rng.randn(2, *shape)
    rz = ch.compute_backward_mean(_t(az), _t(bz), _t(ax), _t(bx)).numpy()
    G = _dense(ch, shape)
    N = shape[0] * shape[1]
    want = np.linalg.solve(az * np.eye(N) + ax * G.T @ G,
                           bz.ravel() + G.T @ bx.ravel())
    np.testing.assert_allclose(rz.ravel(), want, rtol=1e-8, atol=1e-10)


def test_dft_channel_roundtrip():
    rng = np.random.RandomState(2)
    N = 12
    ch = DFTChannel(real=True)
    z = rng.randn(N)
    X = ch.sample(None, _t(z))
    assert X.shape == (2, N)
    np.testing.assert_allclose(X[0].numpy() + 1j * X[1].numpy(),
                               np.fft.fft(z, norm="ortho"), atol=1e-10)
    a_f, b_f = ch.compute_forward_message(_t(1.0), _t(z), _t(0.0),
                                          torch.zeros(2, N, dtype=F64))
    a_b, b_b = ch.compute_backward_message(_t(0.0), torch.zeros(N, dtype=F64),
                                           _t(1.0), b_f)
    np.testing.assert_allclose(b_b.numpy(), z, atol=1e-10)


def test_rotation_channel():
    rng = np.random.RandomState(3)
    Q, _ = np.linalg.qr(rng.randn(6, 6))
    ch = RotationChannel(R=Q, **CPU)
    bz = rng.randn(6)
    a_f, b_f = ch.compute_forward_message(_t(1.2), _t(bz), _t(0.0),
                                          torch.zeros(6, dtype=F64))
    np.testing.assert_allclose(b_f.numpy(), Q @ bz, atol=1e-10)
    assert float(a_f) == 1.2
    with pytest.raises(ValueError, match="not a rotation"):
        RotationChannel(R=Q + 0.1, **CPU)


def test_blur_and_laplacian_build():
    assert Blur1DChannel(sigma=2.0, N=32, **CPU).spectrum.shape == (32,)
    assert LaplacianChannel(shape=(8, 8), **CPU).spectrum.shape == (8, 8)


# -- every method against the JAX package -----------------------------------
def _jax_channel(kind, rng):
    "(JAX channel, z shape, x shape)."
    if kind == "conv_1d":
        return jch.ConvChannel(filter=rng.randn(10)), (10,), (10,)
    if kind == "conv_2d":
        return jch.ConvChannel(filter=rng.randn(5, 6)), (5, 6), (5, 6)
    if kind == "conv_1d_complex":
        return (jch.ConvChannel(filter=rng.randn(9), real=False), (2, 9),
                (2, 9))
    if kind == "conv_2d_complex":
        return (jch.ConvChannel(filter=rng.randn(4, 5), real=False),
                (2, 4, 5), (2, 4, 5))
    if kind == "differential_2d":
        return (jch.DifferentialChannel(D1=[1.0, 0.5], D2=[0.2, 0.1],
                                        shape=(6, 5)), (6, 5), (6, 5))
    if kind == "laplacian_2d":
        return jch.LaplacianChannel(shape=(5, 7)), (5, 7), (5, 7)
    if kind == "blur_1d":
        return jch.Blur1DChannel(sigma=1.5, N=16), (16,), (16,)
    if kind == "blur_2d":
        return (jch.Blur2DChannel(sigma=(1.0, 2.0), shape=(6, 8)), (6, 8),
                (6, 8))
    if kind == "gradient_1d":
        return jch.GradientChannel(shape=(12,)), (12,), (1, 12)
    if kind == "gradient_2d":
        return jch.GradientChannel(shape=(5, 6)), (5, 6), (2, 5, 6)
    if kind == "dft_1d":
        return jch.DFTChannel(real=True), (11,), (2, 11)
    if kind == "dft_2d":
        return jch.DFTChannel(real=True), (4, 6), (2, 4, 6)
    if kind == "dft_1d_complex":
        return jch.DFTChannel(real=False), (2, 10), (2, 10)
    Q, _ = np.linalg.qr(rng.randn(9, 9))
    return jch.RotationChannel(R=Q), (9,), (9,)


KINDS = ["conv_1d", "conv_2d", "conv_1d_complex", "conv_2d_complex",
         "differential_2d", "laplacian_2d", "blur_1d", "blur_2d",
         "gradient_1d", "gradient_2d", "dft_1d", "dft_2d", "dft_1d_complex",
         "rotation"]
EP_METHODS = ("compute_forward_message", "compute_backward_message",
              "compute_log_partition")
POSTERIORS = ("compute_forward_posterior", "compute_backward_posterior")
SE_METHODS = ("compute_forward_state_evolution",
              "compute_backward_state_evolution",
              "compute_mutual_information", "compute_free_energy")
ERRORS = ("compute_forward_error", "compute_backward_error")


def _lane(x, i, lanes):
    "Lane i of a port output: the lane's slice, or the lone value."
    if lanes is None:
        return x
    return x[i] if x.ndim and x.shape[0] == lanes else x


@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_structured_channel_ep_methods(kind, lanes):
    rng = np.random.RandomState(KINDS.index(kind))
    jc, zs, xs = _jax_channel(kind, rng)
    ch = _port(jc)
    lead = () if lanes is None else (lanes,)
    az = rng.uniform(0.5, 3.0, lead + (1,) * len(zs) if lanes else ())
    ax = rng.uniform(0.5, 3.0, lead + (1,) * len(xs) if lanes else ())
    bz, bx = rng.randn(*lead, *zs), rng.randn(*lead, *xs)
    names = list(EP_METHODS) + (
        [] if kind.startswith(("dft", "rotation")) else list(POSTERIORS))
    for method in names:
        got = getattr(ch, method)(_t(az), _t(bz), _t(ax), _t(bx))
        for i in range(lanes or 1):
            pick = (lambda x: x) if lanes is None else (lambda x: x[i])
            want = getattr(jc, method)(
                float(np.ravel(az)[i]), jnp.asarray(pick(bz)),
                float(np.ravel(ax)[i]), jnp.asarray(pick(bx)))
            if method == "compute_log_partition":
                assert_close(_lane(got, i, lanes), want, RTOL,
                             what=f"{kind} {method} lane {i}")
                continue
            for g, w in zip(got, want):
                g = _lane(g, i, lanes)
                assert_close(g.reshape(np.shape(w)), w, RTOL,
                             what=f"{kind} {method} lane {i}")
    # a precision comes back in the lane shape of the side it goes to
    if lanes:
        a_f, _ = ch.compute_forward_message(_t(az), _t(bz), _t(ax), _t(bx))
        a_b, _ = ch.compute_backward_message(_t(az), _t(bz), _t(ax), _t(bx))
        assert a_f.shape == ax.shape and a_b.shape == az.shape


@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_structured_channel_se_methods(kind, lanes):
    """n_eff, second moment, errors, SE updates, mutual information and
    free energy, with precisions 0-d or ``(3, 1)``."""
    rng = np.random.RandomState(20 + KINDS.index(kind))
    jc, _, _ = _jax_channel(kind, rng)
    ch = _port(jc)
    shape = () if lanes is None else (lanes, 1)
    az, ax = rng.uniform(0.5, 3.0, shape), rng.uniform(0.5, 3.0, shape)
    tau = rng.uniform(0.5, 2.0, shape)
    # the methods the JAX class defines (its base class's free energy
    # needs a beliefs measure that these channels do not have)
    if kind.startswith(("dft", "rotation")):
        names = list(SE_METHODS)
    elif kind.startswith("gradient"):
        names = list(SE_METHODS[:2] + ERRORS) + ["compute_n_eff"]
    else:
        names = list(SE_METHODS + ERRORS) + ["compute_n_eff"]
    for method in names + ["second_moment"]:
        args = ((tau,) if method == "second_moment" else
                (az, ax) if method == "compute_n_eff" else (az, ax, tau))
        got = getattr(ch, method)(*map(_t, args))
        for i in range(lanes or 1):
            want = getattr(jc, method)(
                *(float(np.ravel(a)[i]) for a in args))
            assert_close(_lane(got, i, lanes).reshape(np.shape(want)), want,
                         RTOL, what=f"{kind} {method} lane {i}")
        if lanes:
            assert got.shape == shape, (method, got.shape)


def test_conv_channel_complex_sample():
    "real=False samples a packed complex field, as the JAX channel."
    rng = np.random.RandomState(5)
    jc, zs, _ = _jax_channel("conv_1d_complex", rng)
    ch = _port(jc)
    Z = rng.randn(*zs)
    assert_close(ch.sample(None, _t(Z)), jc.sample(None, jnp.asarray(Z)),
                 RTOL)


def test_registry_builds_the_structured_channels():
    built = {
        "conv": dict(filter=np.ones(4)), "blur_1d": dict(sigma=1.0, N=8),
        "blur_2d": dict(sigma=(1.0, 1.0), shape=(4, 4)),
        "differential": dict(D1=[1.0], D2=None, shape=(6,)),
        "laplacian": dict(shape=(4, 4)), "gradient": dict(shape=(4, 5))}
    for kind, kw in built.items():
        ch = get_channel(kind, **kw, **CPU)
        assert ch.spectrum.dtype == F64 and ch.spectrum.device.type == "cpu"
    assert get_channel("dft", real=False).real is False
    Q = np.eye(3)
    assert get_channel("rotation", R=Q, **CPU).N == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_channel("gradient", shape=(4,))


# -- the ensembles: shapes and moments ---------------------------------------
@pytest.mark.parametrize("kind", ["rotation", "binary", "ternary",
                                  "random_feature"])
def test_structured_ensembles(kind):
    g = torch.Generator().manual_seed(0)
    if kind == "rotation":
        R = ensembles.get_ensemble("rotation", N=64).generate(g, **CPU)
        assert R.shape == (64, 64)
        np.testing.assert_allclose((R @ R.T).numpy(), np.eye(64), atol=1e-10)
        assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-8
        RotationChannel(R, **CPU)
        return
    M, N = 300, 400
    if kind == "binary":
        X = ensembles.get_ensemble("binary", M=M, N=N, p_pos=0.25).generate(
            g, **CPU)
        assert set(np.unique(X.numpy() * np.sqrt(N))) == {-1.0, 1.0}
        # P(+) = 0.25: 120000 draws, 5 standard deviations of 0.0013
        assert abs(float((X > 0).double().mean()) - 0.25) < 7e-3
    elif kind == "ternary":
        X = ensembles.get_ensemble("ternary", M=M, N=N, p_pos=0.2,
                                   p_neg=0.3).generate(g, **CPU)
        values = np.round(X.numpy() * np.sqrt(N))
        assert set(np.unique(values)) == {-1.0, 0.0, 1.0}
        for v, p in ((-1.0, 0.3), (0.0, 0.5), (1.0, 0.2)):
            assert abs(float(np.mean(values == v)) - p) < 7e-3
    else:
        ens = ensembles.get_ensemble("random_feature", M=M, N=N, f="tanh")
        X = ens.generate(g, **CPU)
        # f(W Z) with W Z ~ N(0, 1) entrywise: E tanh(g)^2 = 0.3943
        second = float((X**2).mean()) * N
        assert abs(second - 0.3943) < 0.02
        for f in ens.ACTIVATIONS:
            Y = ensembles.get_ensemble("random_feature", M=4, N=5,
                                       f=f).generate(g, **CPU)
            assert Y.shape == (4, 5) and bool(torch.isfinite(Y).all())
    assert X.shape == (M, N) and X.dtype == F64
