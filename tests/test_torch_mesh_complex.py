"""The model axis through the complex products (``utils.misc.pair_matmul``)
in a whole EP solve, in ``gloo`` worlds of 2 and 4 processes on the CPU
(tests/torch_mesh_worker.py): a real Gauss-Bernoulli prior on a packed
(2, N) variable, a ``UnitaryChannel`` Q, a ``ComplexLinearChannel`` F per
lane and Gaussian noise on the packed output, N = 32, M = 48, 8 lanes,
float64, made here with numpy from a seed. Both complex channels split
their operators over the model axis; the port's complex channels are held
against the JAX package's in tests/test_torch_complex_channels.py and
tests/test_torch_phase_retrieval.py, so the reference here is the port's
unsharded solve, run in this process. Tolerances: a split over the data
axis alone gives every lane the bits of the unsharded solve (r, v,
n_iter); with the model axis split, EP's tolerance of
tests/test_parallel.py:58-60, rtol 1e-6, atol 1e-8.
"""
import numpy as np
import pytest

import torch_mesh_worker as worker

N, M, B = 32, 48, 8
IDS = ("x", "u", "z")


def _inputs():
    rng = np.random.RandomState(1)
    F = (rng.randn(B, M, N) + 1j * rng.randn(B, M, N)) / np.sqrt(2 * N)
    Q, _ = np.linalg.qr(rng.randn(N, N) + 1j * rng.randn(N, N))
    x = (rng.rand(B, 1, N) < 0.5) * rng.randn(B, 2, N)
    z = np.einsum("bmn,nk,bk->bm", F, Q, x[:, 0] + 1j * x[:, 1])
    y = np.stack([z.real, z.imag], axis=1) + 0.1 * rng.randn(B, 2, M)
    return {"cx_F_re": F.real, "cx_F_im": F.imag, "cx_Q_re": Q.real,
            "cx_Q_im": Q.imag, "cx_y": y}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """{world: [rank results]} and the unsharded solve, solved here while
    the worlds run."""
    import torch
    import tramp_tpu_torch as tt
    from tramp_tpu_torch import parallel
    data = _inputs()
    path = tmp_path_factory.mktemp("mesh_complex")
    np.savez(path / "inputs.npz", **data)
    waits = {w: worker.launch("complex", w, path) for w in (2, 4)}
    models = worker.complex_chain(torch, tt, data)
    post, n_iter = parallel.EPSolver(models[0], **worker.EP_COMPLEX) \
        .solve_batch(parallel.stack_models(models))
    want = ({vid: {k: post[vid][k].numpy() for k in ("r", "v")}
             for vid in IDS}, n_iter.numpy())
    for wait in waits.values():
        wait()
    return {w: worker.results(path, w) for w in (2, 4)}, want


def _post(res, key):
    return ({vid: {k: res[f"{key}/complex/{vid}/{k}"] for k in ("r", "v")}
             for vid in IDS}, res[f"{key}/complex/n_iter"])


@pytest.mark.parametrize("world", [2, 4])
def test_the_unsharded_solve_converges(run, world):
    "The reference: every lane converged, r of the packed shapes."
    post, n_iter = run[1]
    assert post["x"]["r"].shape == (B, 2, N)
    assert post["z"]["r"].shape == (B, 2, M)
    assert (n_iter < worker.EP_COMPLEX["max_iter"]).all()
    for res in run[0][world]:
        assert _post(res, f"{world}x1")[0]["u"]["r"].shape == (B, 2, N)


@pytest.mark.parametrize("world", [2, 4])
def test_data_axis_gives_the_unsharded_bits(run, world):
    post_w, n_w = run[1]
    for res in run[0][world]:
        post, n_iter = _post(res, f"{world}x1")
        np.testing.assert_array_equal(n_iter, n_w)
        for vid in IDS:
            for k in ("r", "v"):
                np.testing.assert_array_equal(post[vid][k], post_w[vid][k],
                                              err_msg=f"{vid} {k}")


@pytest.mark.parametrize("world,shape", [(2, (1, 2)), (4, (2, 2))])
def test_model_axis_agrees_with_the_unsharded_solve(run, world, shape):
    post_w, _ = run[1]
    key = "x".join(map(str, shape))
    for res in run[0][world]:
        post, _ = _post(res, key)
        for vid in IDS:
            for k in ("r", "v"):
                np.testing.assert_allclose(post[vid][k], post_w[vid][k],
                                           rtol=1e-6, atol=1e-8,
                                           err_msg=f"{vid} {k}")


@pytest.mark.parametrize("world,shape", [(2, (2, 1)), (2, (1, 2)),
                                         (4, (4, 1)), (4, (2, 2))])
def test_each_rank_holds_its_share_of_the_operators(run, world, shape):
    """The unitary channel's U and the complex linear channel's W, U, V on
    a rank: 1/P of the operator bytes for a model axis of P, and 1/D of the
    lanes for a data axis of D."""
    key = "x".join(map(str, shape))
    for res in run[0][world]:
        local, whole = res[f"{key}/bytes"]
        np.testing.assert_array_equal(whole, local * shape[0] * shape[1])
