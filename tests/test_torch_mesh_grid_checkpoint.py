"""The SE phase grid on a device mesh and the elastic checkpoint of
tramp_tpu_torch, in ``gloo`` worlds of 4 and 2 processes on the CPU
(tests/torch_mesh_worker.py, which imports torch and the port only): the
counterparts of tests/test_parallel.py:205-233 (``run_se_phase_grid`` with a
mesh, the CSV on process 0) and tests/test_parallel.py:320-370 (a
checkpoint written under one mesh resumed under others).

The two worlds run at the same time. The world of 4 solves the grid on a
(4,) data mesh and writes the checkpoint of 8 EP lanes (N = 64, alpha 0.7, float64, made here with numpy
from a seed, numpy's SVD handed to both packages) after 7 iterations,
with the uncut solve beside it; the world of 2 solves the grid on (2,) and
restores and resumes the checkpoint, once written, on a (2, 1) and a (1, 2)
mesh; this
process resumes it without a mesh and in the JAX package. Tolerances:

- the grid's records on every rank against the JAX package's
  ``run_se_phase_grid(mesh=...)`` on as many virtual devices: equal points
  and n_iter, v at rtol 1e-8 (tests/test_parallel.py:224); against the
  port's grid without a mesh: equal;
- a resume on a data axis alone, or in one process: the bits of the uncut
  solve; with the model axis split: rtol 1e-8, atol 1e-12
  (tests/test_parallel.py:367-369); in the JAX package: its own uncut
  solve at that tolerance, and the port's uncut solve at rtol 1e-8 of
  ``torch_parity.assert_close``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import tramp_tpu as jt
from tramp_tpu import parallel as jparallel

import torch_mesh_worker as worker
from test_torch_mesh import _jax_models, with_svd
from torch_parity import assert_close

N, ALPHA, B = 64, 0.7, 8


def _inputs():
    rng = np.random.RandomState(3)
    M = int(ALPHA * N)
    W = rng.randn(B, M, N) / np.sqrt(N)
    x = (rng.rand(B, N) < 0.3) * rng.randn(B, N)
    y = np.einsum("bmn,bn->bm", W, x) + 0.1 * rng.randn(B, M)
    return with_svd({}, "glm", W, y)


def _jax_grid(world):
    devices = np.array(jax.devices())
    kw = dict(worker.GRID_KW)
    df = jparallel.run_se_phase_grid(
        jt.glm_state_evolution, grid_kwargs=worker.GRID,
        mesh=Mesh(devices[:world], ("data",)), **kw)
    return {k: df[k].to_numpy() for k in ("alpha", "prior_rho", "v",
                                         "n_iter")}


def _jax_solver(models, max_iter, tol=1e-8):
    return jparallel.EPSolver(models[0], damping=0.1, max_iter=max_iter,
                              tol=tol, rollback_increase=float("inf"))


def _jax_state_from(path, like):
    """The JAX package's batched EP state ``like`` filled from the port's
    checkpoint file: the keys name the same slots and spectral images; a
    precision per lane is ``(B, 1)`` in the port and ``(B,)`` there."""
    with np.load(path / "checkpoint.npz") as f:
        data = {k: f[k] for k in f.files}

    def fill(tree, key):
        if isinstance(tree, dict):
            return {k: fill(v, f"{key}.{k}") for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(fill(v, f"{key}.{i}")
                              for i, v in enumerate(tree))
        return jnp.asarray(data[key].reshape(tree.shape), tree.dtype)
    return fill(like, "state"), data["n_iter"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results of both worlds, the checkpoint's directory and
    the references computed here."""
    import torch
    import tramp_tpu_torch as tt
    from tramp_tpu_torch import parallel
    data = _inputs()
    path = tmp_path_factory.mktemp("mesh_grid_checkpoint")
    np.savez(path / "inputs.npz", **data)
    waits = {w: worker.launch("grid_checkpoint", w, path) for w in (4, 2)}
    models = _jax_models(data, "glm", relu=False)
    refs = {"jax_grid": {w: _jax_grid(w) for w in (2, 4)}}
    refs["grid"] = parallel.se_phase_grid_records(
        tt.glm_state_evolution, worker.GRID, device="cpu", **worker.GRID_KW)
    stacked = jparallel.stack_pytrees(models)
    j_solver = _jax_solver(models, worker.FULL)
    refs["jax_full"] = np.asarray(j_solver.solve_batch(stacked)[0]["x"]["r"])
    # a batched state of the structure to fill (max_iter is an argument of
    # the compiled loop, so this runs the same executable)
    j_solver.max_iter = 1
    _, j_like, _ = j_solver.solve_batch_with_state(stacked)
    waits[4]()
    # resumed in one process, without a mesh
    glms = worker._models(torch, tt, data, "glm")
    solver = parallel.EPSolver(glms[0], damping=0.1, max_iter=1, tol=1e-8,
                               rollback_increase=float("inf"))
    p_stacked = parallel.stack_models(glms)
    _, like, n_like = solver.solve_batch_with_state(p_stacked)
    state, _ = parallel.restore_checkpoint(path / "ckpt",
                                           like=(like, n_like))
    solver.max_iter = worker.FULL - worker.CUT
    refs["one"] = solver.solve_batch(p_stacked, state=state)[0]["x"]["r"]
    # resumed in the JAX package
    j_state, refs["jax_n_cut"] = _jax_state_from(path / "ckpt", j_like)
    j_solver.max_iter = worker.FULL - worker.CUT
    refs["jax_resumed"] = np.asarray(
        j_solver.solve_batch(stacked, state=j_state)[0]["x"]["r"])
    waits[2]()
    return {w: worker.results(path, w) for w in (2, 4)}, path, refs


@pytest.mark.parametrize("world", [2, 4])
def test_grid_on_a_mesh_matches_jax(run, world):
    """Every rank holds the whole grid, padded and trimmed (6 points over 4
    ranks), within rtol 1e-8 of the JAX package's grid on as many devices,
    and equal to the port's grid without a mesh."""
    want = run[2]["jax_grid"][world]
    plain = run[2]["grid"]
    for res in run[0][world]:
        for k in ("alpha", "prior_rho", "n_iter"):
            np.testing.assert_array_equal(res[f"grid/{k}"], want[k])
            assert res[f"grid/{k}"].tolist() == [r[k] for r in plain]
        np.testing.assert_allclose(res["grid/v"], want["v"], rtol=1e-8)
        assert res["grid/v"].tolist() == [r["v"] for r in plain]


@pytest.mark.parametrize("world", [2, 4])
def test_grid_csv_is_written_by_rank_0(run, world):
    "save_grid_csv writes on rank 0 alone and returns False elsewhere."
    flags = [bool(res["grid/csv_written"]) for res in run[0][world]]
    assert flags == [True] + [False] * (world - 1)
    csv = run[1] / f"grid_{world}.csv"
    assert sum(1 for _ in open(csv)) == 7


def test_checkpoint_holds_the_whole_batch(run):
    """The 4 ranks' checkpoint holds 8 lanes cut after 7 iterations; the
    same state saved from each rank's lanes (gathered) is the same file."""
    path = run[1]
    with np.load(path / "ckpt" / "checkpoint.npz") as a, \
            np.load(path / "ckpt_parts" / "checkpoint.npz") as b:
        assert set(a.files) == set(b.files) and len(a.files) > 4
        for k in a.files:
            assert a[k].shape[0] == B, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["n_iter"].tolist() == [worker.CUT] * B


@pytest.mark.parametrize("shape", worker.MESHES[2])
def test_restore_gives_each_rank_its_lanes(run, shape):
    """Under 2 ranks, each rank restores the lanes that this mesh gives it
    (4 each on (2, 1), all 8 on (1, 2)), with the checkpoint's bits."""
    key = "x".join(map(str, shape))
    with np.load(run[1] / "ckpt" / "checkpoint.npz") as f:
        saved = {k: f[k] for k in f.files}
    width = B // shape[0]
    for rank, res in enumerate(run[0][2]):
        lanes = slice((rank // shape[1]) * width,
                      (rank // shape[1] + 1) * width)
        restored = {k.split("/restored.")[1]: v for k, v in res.items()
                    if k.startswith(f"{key}/restored.")}
        assert set(restored) == {k[len("state."):] for k in saved
                                 if k.startswith("state.")}
        for k, v in restored.items():
            np.testing.assert_array_equal(v, saved[f"state.{k}"][lanes])
        assert res[f"{key}/n_cut"].tolist() == [worker.CUT] * B


@pytest.mark.parametrize("shape", worker.MESHES[2])
def test_resume_under_2_ranks_reaches_the_uncut_solve(run, shape):
    """Written by 4 ranks, resumed under 2: the uncut solve's bits on a
    data axis, rtol 1e-8 with the model axis split."""
    want = run[0][4][0]["4x1/full/x/r"]
    key = "x".join(map(str, shape))
    for res in run[0][2]:
        got = res[f"{key}/resumed/x/r"]
        if shape[1] == 1:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


def test_resume_in_one_process_reaches_the_uncut_solve(run):
    "Written by 4 ranks, resumed without a mesh: the uncut solve's bits."
    np.testing.assert_array_equal(run[2]["one"].numpy(),
                                  run[0][4][0]["4x1/full/x/r"])


def test_resume_in_the_jax_package(run):
    """The checkpoint read into the JAX package's batched EP state and
    resumed there: its own uncut solve at tests/test_parallel.py's rtol
    1e-8, atol 1e-12, and the port's uncut solve at rtol 1e-8."""
    refs = run[2]
    assert refs["jax_n_cut"].tolist() == [worker.CUT] * B
    np.testing.assert_allclose(refs["jax_resumed"], refs["jax_full"],
                               rtol=1e-8, atol=1e-12)
    assert_close(run[0][4][0]["4x1/full/x/r"], refs["jax_full"], 1e-8)
