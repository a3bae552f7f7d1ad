"""The device mesh of tramp_tpu_torch (``parallel.mesh``) in ``gloo``
worlds of 2 and 4 processes on the CPU, against the port's unsharded solves
and the JAX package's sharded ones on its 8 virtual devices: the
counterparts of tests/test_parallel.py:42-127 and tests/test_vamp_glm.py:
107-125, and the bytes per rank of __graft_entry__.py:90-99.

The instances are made here with numpy from a seed (8 lanes of a GLM and of
a relu net, N = 64, M = 32, float64; numpy's SVD handed to both packages),
and tests/torch_mesh_worker.py, which imports torch and the port
only, runs every scenario in each world once (a module fixture), while this
process runs the JAX side. Tolerances:

- a split over the data axis alone gives every lane the bits of the port's
  unsharded solve (r, v, n_iter; converged lanes are frozen);
- a split over the model axis changes the order of summation of each
  product: EP at rtol 1e-6, atol 1e-8 (tests/test_parallel.py:58-60),
  spectral VAMP and ML-VAMP at rtol 1e-10, atol 1e-13 with equal n_iter
  (tests/test_vamp_glm.py:120-125), against the unsharded solve;
- against the JAX package's sharded solve on the same mesh shape: equal
  n_iter, r and v at rtol 1e-8 of ``torch_parity.assert_close`` (the parity
  tests' tolerance for a whole solve); EP's r at tests/test_parallel.py's
  own rtol 1e-6, atol 1e-8 where the model axis splits the operator;
- the products of the model axis: 1e-13 of the product's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import tramp_tpu as jt
from tramp_tpu import parallel as jparallel
from tramp_tpu.channels import GaussianChannel as JGaussianChannel
from tramp_tpu.channels import LinearChannel as JLinearChannel
from tramp_tpu.channels import ReluChannel as JReluChannel
from tramp_tpu.priors import GaussBernoulliPrior as JGaussBernoulliPrior

import torch_mesh_worker as worker
from torch_parity import assert_close

N, M, B = 64, 32, 8
KINDS = ("ep", "vamp", "mlvamp")
IDS = {"ep": ("x", "z"), "vamp": ("x", "z"), "mlvamp": ("x", "z", "a")}
MODEL_RTOL = {"ep": (1e-6, 1e-8), "vamp": (1e-10, 1e-13),
              "mlvamp": (1e-10, 1e-13)}


def _instances(rng, relu):
    W = rng.randn(B, M, N) / np.sqrt(N)
    x = (rng.rand(B, N) < 0.3) * rng.randn(B, N)
    z = np.einsum("bmn,bn->bm", W, x)
    if relu:
        z = np.maximum(z, 0.0)
    return W, z + 0.1 * rng.randn(B, M)


def _jax_models(data, name, relu):
    "The JAX package's students of the instances ``name`` in ``data``."
    models = []
    for Wi, yi, U, s, V in zip(*(data[f"{name}_{k}"]
                                 for k in ("W", "y", "U", "s", "V"))):
        linear = JLinearChannel(jnp.asarray(Wi), name="W", svd=(U, s, V.T))
        m = (JGaussBernoulliPrior(size=Wi.shape[1], rho=0.3) @ jt.V(id="x")
             @ linear @ jt.V(id="z"))
        if relu:
            m = m @ JReluChannel() @ jt.V(id="a")
        m = (m @ JGaussianChannel(var=1e-2) @ jt.O(id="y")).to_model()
        models.append(m.to_observed({"y": jnp.asarray(yi)}))
    return models


def with_svd(data, name, W, y):
    """``data`` with the instances ``name``: W, y and numpy's thin SVD, U,
    s and V = Vt.T, which both packages take."""
    U, s, Vt = np.linalg.svd(W, full_matrices=False)
    data.update({f"{name}_W": W, f"{name}_y": y, f"{name}_U": U,
                 f"{name}_s": s, f"{name}_V": np.swapaxes(Vt, 1, 2)})
    return data


def _inputs():
    rng = np.random.RandomState(0)
    data = {}
    for name, relu in (("glm", False), ("relu", True)):
        with_svd(data, name, *_instances(rng, relu))
    # the products of the model axis: A (B, n, m) real, C complex
    n, m = 24, 32
    data["prod_A"] = rng.randn(B, n, m)
    data["prod_x"], data["prod_xt"] = rng.randn(B, m), rng.randn(B, n)
    data["prod_C_re"], data["prod_C_im"] = (rng.randn(B, n, m),
                                            rng.randn(B, n, m))
    data["prod_z"], data["prod_zt"] = rng.randn(B, 2, m), rng.randn(B, 2, n)
    return data


def _jax_post(post, n_iter):
    return ({vid: {k: np.asarray(d[k]) for k in ("r", "v")}
             for vid, d in post.items()}, np.asarray(n_iter))


def _jax_references(data):
    "The JAX package's solves on a (2, 2) mesh and its shard_map on (4,)."
    models = {"glm": _jax_models(data, "glm", relu=False),
              "relu": _jax_models(data, "relu", relu=True)}
    devices = np.array(jax.devices())
    mesh = Mesh(devices[:4].reshape(2, 2), ("data", "model"))
    solvers = {
        "ep": (models["glm"], jparallel.EPSolver(models["glm"][0],
                                                 **worker.EP)),
        "vamp": (models["glm"], jparallel.dispatch_solver(
            models["glm"][0], **worker.VAMP)),
        "mlvamp": (models["relu"], jparallel.dispatch_solver(
            models["relu"][0], **worker.MLVAMP))}
    refs = {}
    for kind, (ms, solver) in solvers.items():
        sharded = jparallel.shard_batched_model(
            jparallel.stack_pytrees(ms), mesh)
        with mesh:
            refs[kind] = _jax_post(*solver.solve_batch(sharded))
    data_mesh = Mesh(devices[:4], ("data",))
    post, n_iter, n_conv = jparallel.solve_batch_shard_map(
        solvers["ep"][1], jparallel.stack_pytrees(models["glm"]), data_mesh)
    refs["shard_map"] = _jax_post(post, n_iter) + (int(n_conv),)
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """{world: [rank results]} of both worlds, each rank's with the port's
    unsharded solves (keys ``none/...``, solved here), and the JAX
    references."""
    import torch
    import tramp_tpu_torch as tt
    from tramp_tpu_torch import parallel
    data = _inputs()
    dirs, waits = {}, {}
    for world in (2, 4):
        dirs[world] = tmp_path_factory.mktemp(f"mesh{world}")
        np.savez(dirs[world] / "inputs.npz", **data)
        waits[world] = worker.launch("solvers", world, dirs[world])
    refs = _jax_references(data)
    none = worker.unsharded(torch, tt, parallel, data)
    for wait in waits.values():
        wait()
    return {w: [dict(r, **none) for r in worker.results(d, w)]
            for w, d in dirs.items()}, refs


def _post(res, key, kind):
    return ({vid: {k: res[f"{key}/{vid}/{k}"] for k in ("r", "v")}
             for vid in IDS[kind]}, res[f"{key}/n_iter"])


def _assert_same_bits(got, want):
    (post, n_iter), (post_w, n_iter_w) = got, want
    np.testing.assert_array_equal(n_iter, n_iter_w)
    for vid in post_w:
        for k in ("r", "v"):
            np.testing.assert_array_equal(post[vid][k], post_w[vid][k],
                                          err_msg=f"{vid} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_helpers(run, world):
    """``make_mesh`` defaults to (world, 1) and refuses a shape whose
    product is not the world size, as tramp_tpu/parallel/mesh.py:19."""
    res = run[0][world][0]
    assert res["default_shape"].tolist() == [world, 1]
    assert f"!= {world} processes" in str(res["bad_shape"])
    for shape in worker.MESHES[world]:
        key = "x".join(map(str, shape))
        assert res[f"{key}/shape"].tolist() == list(shape)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_holds_the_whole_batch(run, world):
    "Every rank returns the same results, the whole batch of 8 lanes."
    ranks = run[0][world]
    for key, value in ranks[0].items():
        if key.endswith("/r"):
            assert value.shape[0] == B, key
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[key], value, err_msg=key)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("world", [2, 4])
def test_data_axis_gives_the_unsharded_bits(run, world, kind):
    """``solve_batch`` on a model sharded over the data axis alone: every
    lane's r, v and n_iter are those of the unsharded solve."""
    res = run[0][world][0]
    want = _post(res, f"none/{kind}/solve_batch", kind)
    _assert_same_bits(_post(res, f"{world}x1/{kind}/solve_batch", kind),
                      want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("world", [2, 4])
def test_shard_map_gives_the_unsharded_bits(run, world, kind):
    """``solve_batch_shard_map``: each rank stops on its own lanes; every
    lane has the bits of the unsharded solve, a second call the same bits,
    and the converged count is that of the unsharded solve's flags."""
    res = run[0][world][0]
    want = _post(res, f"none/{kind}/solve_batch", kind)
    for call in ("shard_map", "shard_map_again")[:2 if kind == "ep" else 1]:
        _assert_same_bits(_post(res, f"{world}x1/{kind}/{call}", kind), want)
        assert int(res[f"{world}x1/{kind}/{call}/n_conv"]) == int(
            res[f"none/{kind}/conv"].sum())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("world,shape", [(2, (1, 2)), (4, (2, 2))])
def test_model_axis_agrees_with_the_unsharded_solve(run, world, shape,
                                                    kind):
    """The operators split over a model axis of 2: the JAX tests'
    tolerances against the unsharded solve, equal n_iter for the VAMP
    solvers, through ``solve_batch`` and ``solve_batch_shard_map``."""
    res = run[0][world][0]
    rtol, atol = MODEL_RTOL[kind]
    post_w, n_w = _post(res, f"none/{kind}/solve_batch", kind)
    key = "x".join(map(str, shape))
    for call in ("solve_batch", "shard_map"):
        post, n_iter = _post(res, f"{key}/{kind}/{call}", kind)
        if kind != "ep":
            np.testing.assert_array_equal(n_iter, n_w)
        for vid in post_w:
            for k in ("r", "v"):
                np.testing.assert_allclose(post[vid][k], post_w[vid][k],
                                           rtol=rtol, atol=atol,
                                           err_msg=f"{call} {vid} {k}")


@pytest.mark.parametrize("world,shape", [(2, (1, 2)), (4, (2, 2)),
                                         (4, (1, 4))])
def test_each_rank_holds_its_share_of_the_operators(run, world, shape):
    """__graft_entry__.py:90-99's assertion: a rank holds 1/P of the linear
    channel's operator bytes (W, U, V) for a model axis of P, and of those
    1/D for the lanes of a data axis of D."""
    res = run[0][world]
    key = "x".join(map(str, shape))
    for rank in res:
        local, whole = rank[f"{key}/bytes"]
        assert whole == local * shape[0] * shape[1]


@pytest.mark.parametrize("world,shape", [(2, (1, 2)), (4, (2, 2)),
                                         (4, (1, 4))])
def test_model_axis_products(run, world, shape):
    """``LinearChannel._mm`` (one operator and one per lane, with and
    without lanes and a trailing K axis, both directions) and
    ``pair_matmul`` (one instance, lanes, one operator per lane, both
    directions) on this rank's block of the operator give the whole
    product on every rank."""
    key = "x".join(map(str, shape))
    for rank in run[0][world]:
        errs = rank[f"{key}/products"]
        assert errs.shape == (18,)
        assert errs.max() < 1e-13, errs


@pytest.mark.parametrize("world,shape", [(2, (1, 2)), (4, (2, 2)),
                                         (4, (1, 4))])
def test_model_axis_products_bf16(run, world, shape):
    """The same products with bfloat16 operands (``config.MATVEC_BF16``):
    float32 blocks summed over the model axis, each element within 1e-5 of
    |A| @ |x| of the whole product (the blocks' float32 sums run in another
    order)."""
    key = "x".join(map(str, shape))
    for rank in run[0][world]:
        errs = rank[f"{key}/products_bf16"]
        assert errs.shape == (12,)
        assert errs.max() < 1e-5, errs


def test_gated_bf16_on_the_data_axis_gives_the_unsharded_bits(run):
    """``EPSolver.solve_batch_gated_bf16`` on the float32 GLMs sharded over
    a gloo world of 2 on (2, 1): both phases run one loop over the ranks,
    and every lane's r, v, n_iter and converged flag are those of the
    unsharded gated solve."""
    for rank in run[0][2]:
        _assert_same_bits(_post(rank, "2x1/gated", "ep"),
                          _post(rank, "none/gated", "ep"))
        np.testing.assert_array_equal(rank["2x1/gated/conv"],
                                      rank["none/gated/conv"])
        assert rank["2x1/gated/conv"].all()


@pytest.mark.parametrize("world", [2, 4])
def test_shard_map_errors(run, world):
    """tramp_tpu/parallel/solver.py:388-395: a list of initializers names
    ``solve_batch``; a batch the data axis does not divide is refused."""
    res = run[0][world][0]
    key = f"{world}x1"
    assert "solve_batch" in str(res[f"{key}/error_list"])
    assert f"batch 7 not divisible by data={world}" in str(
        res[f"{key}/error_odd"])


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_solve_against_jax(run, kind):
    """The port on a (2, 2) mesh of 4 processes against the JAX package on
    a (2, 2) mesh of its virtual devices: equal n_iter, the parity tests'
    rtol 1e-8 (EP's r: tests/test_parallel.py's rtol 1e-6, atol 1e-8)."""
    post, n_iter = _post(run[0][4][0], f"2x2/{kind}/solve_batch", kind)
    j_post, j_n = run[1][kind]
    np.testing.assert_array_equal(n_iter, j_n)
    for vid in IDS[kind]:
        for k in ("r", "v"):
            if kind == "ep" and k == "r":
                np.testing.assert_allclose(post[vid][k], j_post[vid][k],
                                           rtol=1e-6, atol=1e-8)
            else:
                assert_close(post[vid][k], j_post[vid][k], 1e-8,
                             what=f"{vid} {k}")


def test_shard_map_against_jax(run):
    """``solve_batch_shard_map`` over a data axis of 4: the port's against
    the JAX package's ``jax.shard_map`` (tests/test_parallel.py:63-104):
    equal n_iter and converged count, r and v at rtol 1e-8."""
    res = run[0][4][0]
    post, n_iter = _post(res, "4x1/ep/shard_map", "ep")
    j_post, j_n, j_conv = run[1]["shard_map"]
    np.testing.assert_array_equal(n_iter, j_n)
    assert int(res["4x1/ep/shard_map/n_conv"]) == j_conv
    for vid in IDS["ep"]:
        for k in ("r", "v"):
            assert_close(post[vid][k], j_post[vid][k], 1e-8,
                         what=f"{vid} {k}")
