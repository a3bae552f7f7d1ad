"""Worker of the tramp_tpu_torch mesh tests: one process of a ``gloo``
world on the CPU, in the manner of tests/multihost_worker.py. It imports
torch and the port only.

Usage: python torch_mesh_worker.py <scenario> <rank> <world> <port> <dir>

``dir`` holds ``inputs.npz``, the instances the parent made with numpy from
a seed, and receives ``rank<r>_of_<world>.npz``, this rank's results, keyed
``<mesh>/<what>``. Scenarios: ``solvers`` (tests/test_torch_mesh.py),
``complex`` (tests/test_torch_mesh_complex.py) and ``grid_checkpoint``
(tests/test_torch_mesh_grid_checkpoint.py).

``launch`` starts a world of these processes from a test and waits for it,
killing every process at its time limit.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# solver settings of the JAX package's tests: tests/test_parallel.py:42-60
# (EP), tests/test_vamp_glm.py:107-125 (spectral VAMP); the relu net's
# ML-VAMP as tests/test_torch_ml_vamp.py solves it
EP = dict(damping=0.1, max_iter=50, tol=1e-8)
VAMP = dict(max_iter=300, tol=1e-10)
MLVAMP = dict(damping=0.1, max_iter=200, tol=1e-8)
EP_COMPLEX = dict(damping=0.1, max_iter=100, tol=1e-8)
# the gated two-phase solve on the float32 GLMs: tests/test_parallel.py:297
GATED = dict(damping=0.1, max_iter=500, tol=1e-6)
MESHES = {2: [(2, 1), (1, 2)], 4: [(4, 1), (2, 2)]}
GRID = {"alpha": [0.3, 0.6, 0.9], "prior_rho": [0.25, 0.5]}
GRID_KW = dict(ids=("x",), a0=0.0, prior_type="gauss_bernoulli",
               output_type="gaussian", output_var=1e-2)
# the elastic checkpoint of tests/test_parallel.py:320-370
CUT, FULL = 7, 100


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(scenario, world, out, timeout=180):
    """Start ``world`` worker processes of ``scenario`` writing to ``out``
    and return a function that waits for them and raises with their
    errors if one failed or the time limit passed (every process is killed
    then)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
         scenario, str(rank), str(world), str(port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    deadline = time.monotonic() + timeout

    def wait():
        errors = []
        try:
            for rank, p in enumerate(procs):
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                if p.returncode:
                    errors.append(f"rank {rank} exit {p.returncode}:\n{err}")
        except subprocess.TimeoutExpired:
            errors.append(f"{scenario} on {world} ranks: over {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if errors:
            raise RuntimeError("\n".join(errors))
    return wait


def results(out, world):
    "The ranks' results: a list of {key: array}."
    out_list = []
    for rank in range(world):
        with np.load(os.path.join(out, f"rank{rank}_of_{world}.npz")) as f:
            out_list.append({k: f[k] for k in f.files})
    return out_list


# ---------------------------------------------------------------- worker
def _models(torch, tt, data, name, relu=False, dtype=None):
    """The port's students of the instances ``name`` in ``data`` (float64
    unless ``dtype`` says otherwise)."""
    from tramp_tpu_torch.channels import (
        GaussianChannel, LinearChannel, ReluChannel)
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    kw = dict(device="cpu", dtype=dtype or torch.float64)
    models = []
    for W, y, U, s, V in zip(*(data[f"{name}_{k}"]
                               for k in ("W", "y", "U", "s", "V"))):
        linear = LinearChannel(W, name="W", svd=(U, s, V.T), **kw)
        m = (GaussBernoulliPrior(size=W.shape[1], rho=0.3, **kw)
             @ tt.V(id="x") @ linear @ tt.V(id="z"))
        if relu:
            m = m @ ReluChannel() @ tt.V(id="a")
        m = (m @ GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
        models.append(m.to_observed({"y": torch.as_tensor(y, **kw)}))
    return models


def _save_post(out, key, post, n_iter):
    for vid, d in post.items():
        for k in ("r", "v"):
            out[f"{key}/{vid}/{k}"] = d[k].numpy()
    out[f"{key}/n_iter"] = n_iter.numpy()


def _error(fn):
    "The message of the ValueError ``fn()`` raises ('' if none)."
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _products(torch, parallel, mesh, data, out, key):
    """The model axis at the two choke points: every case of
    ``LinearChannel._mm`` and ``pair_matmul`` with this rank's block of the
    operator, against the whole product; the largest error relative to the
    product's largest magnitude."""
    from tramp_tpu_torch.channels import LinearChannel
    from tramp_tpu_torch.parallel.mesh import axis_index, axis_size
    from tramp_tpu_torch.utils.misc import ModelShard, pair_matmul
    P = axis_size(mesh, "model")
    shard = ModelShard(mesh.get_group("model"), P, axis_index(mesh, "model"))

    def local(A):
        block = shard.block(A, -1, A.shape[-1] // P).clone()
        block.model_shard = shard
        return block

    A = torch.as_tensor(data["prod_A"])            # (B, n, m)
    x, xt = (torch.as_tensor(data[k]) for k in ("prod_x", "prod_xt"))
    C = torch.complex(*(torch.as_tensor(data[k])
                        for k in ("prod_C_re", "prod_C_im")))
    z, zt = (torch.as_tensor(data[k]) for k in ("prod_z", "prod_zt"))
    cases = {
        "one": (A[0], x[0], xt[0], False),
        "one_K": (A[0], x[0, :, None].repeat(1, 3),
                  xt[0, :, None].repeat(1, 3), False),
        "lanes": (A[0], x, xt, True),
        "lanes_K": (A[0], x[..., None].repeat(1, 1, 3),
                    xt[..., None].repeat(1, 1, 3), True),
        "per_lane": (A, x, xt, True),
        "per_lane_K": (A, x[..., None].repeat(1, 1, 3),
                       xt[..., None].repeat(1, 1, 3), True)}
    errs, errs_bf16 = [], []
    for name, (M, v, vt, lanes) in cases.items():
        for transpose, arg in ((False, v), (True, vt)):
            want = LinearChannel._mm(M, arg, lanes=lanes, transpose=transpose)
            got = LinearChannel._mm(local(M), arg, lanes=lanes,
                                    transpose=transpose)
            errs.append(float((got - want).abs().max() / want.abs().max()))
            # bfloat16 operands (config.MATVEC_BF16): float32 blocks, each
            # element against |A| @ |x| of the whole product
            kw = dict(lanes=lanes, transpose=transpose, bf16=True)
            want = LinearChannel._mm(M, arg, **kw)
            got = LinearChannel._mm(local(M), arg, **kw)
            bound = LinearChannel._mm(M.abs(), arg.abs(), **kw)
            errs_bf16.append(float(((got - want).abs() / bound).max())
                             if got.dtype == torch.float32 else np.inf)
    for M, v, vt, axis in ((C[0], z[0], zt[0], 0), (C[0], z, zt, 1),
                           (C, z, zt, 1)):
        for adjoint, arg in ((False, v), (True, vt)):
            want = pair_matmul(M, arg, adjoint=adjoint, axis=axis)
            got = pair_matmul(local(M), arg, adjoint=adjoint, axis=axis)
            errs.append(float((got - want).abs().max() / want.abs().max()))
    out[f"{key}/products"] = np.array(errs)
    out[f"{key}/products_bf16"] = np.array(errs_bf16)


def _operator_bytes(models, sharded, out, key):
    "The linear channel's operator bytes on this rank, and the whole."
    def nbytes(model):
        f = model.factors[1]
        return sum(f._buffers[k].nbytes for k in f._model_split_fields)
    out[f"{key}/bytes"] = np.array([nbytes(sharded), nbytes(models)])


def build_solvers(torch, tt, parallel, data):
    """{kind: (the instances, the solver)} of EP, spectral VAMP (through
    ``dispatch_solver``, on the GLM) and ML-VAMP (on the relu net)."""
    glms = _models(torch, tt, data, "glm")
    nets = _models(torch, tt, data, "relu", relu=True)
    solvers = {
        "ep": (glms, parallel.EPSolver(glms[0], **EP)),
        "vamp": (glms, parallel.dispatch_solver(glms[0], **VAMP)),
        "mlvamp": (nets, parallel.dispatch_solver(nets[0], **MLVAMP))}
    assert type(solvers["vamp"][1]).__name__ == "SpectralVAMPSolver"
    assert type(solvers["mlvamp"][1]).__name__ == "MLVAMPSolver"
    return solvers


def unsharded(torch, tt, parallel, data):
    "Each solver's unsharded ``solve_batch``, with its converged flags."
    out = {}
    for kind, (models, solver) in build_solvers(torch, tt, parallel,
                                                data).items():
        post, _, n_iter, conv = solver._solve_batch(
            parallel.stack_models(models))
        _save_post(out, f"none/{kind}/solve_batch", post, n_iter)
        out[f"none/{kind}/conv"] = conv.numpy()
    glms = _models(torch, tt, data, "glm", dtype=torch.float32)
    post, n_iter, conv = parallel.EPSolver(
        glms[0], **GATED).solve_batch_gated_bf16(parallel.stack_models(glms))
    _save_post(out, "none/gated", post, n_iter)
    out["none/gated/conv"] = conv.numpy()
    return out


def solvers(torch, tt, parallel, world, data, out):
    """Each solver (EP, spectral VAMP, ML-VAMP) sharded on each mesh of this
    world through ``solve_batch`` and ``solve_batch_shard_map`` (EP's
    twice); the errors; the model axis's bytes and products."""
    solvers = build_solvers(torch, tt, parallel, data)
    glms = solvers["ep"][0]
    out["default_shape"] = np.array(parallel.make_mesh(device="cpu").shape)
    out["bad_shape"] = np.array(_error(
        lambda: parallel.make_mesh((world + 1, 1), device="cpu")))
    for shape in MESHES[world] + ([(1, 4)] if world == 4 else []):
        mesh = parallel.make_mesh(shape, device="cpu")
        key = "x".join(map(str, shape))
        out[f"{key}/shape"] = np.array(mesh.shape)
        stacked = parallel.stack_models(glms)
        sharded = parallel.shard_batched_model(stacked, mesh)
        _operator_bytes(stacked, sharded, out, key)
        if shape[1] > 1:
            _products(torch, parallel, mesh, data, out, key)
        if shape == (1, 4):
            continue
        for kind, (models, solver) in solvers.items():
            stacked = parallel.stack_models(models)
            sharded = parallel.shard_batched_model(stacked, mesh)
            _save_post(out, f"{key}/{kind}/solve_batch",
                       *solver.solve_batch(sharded))
            for call in ("shard_map", "shard_map_again")[
                    :2 if kind == "ep" else 1]:
                post, n_iter, n_conv = parallel.solve_batch_shard_map(
                    solver, stacked, mesh)
                _save_post(out, f"{key}/{kind}/{call}", post, n_iter)
                out[f"{key}/{kind}/{call}/n_conv"] = n_conv.numpy()
        if shape == (2, 1):
            glms32 = _models(torch, tt, data, "glm", dtype=torch.float32)
            post, n_iter, conv = parallel.EPSolver(
                glms32[0], **GATED).solve_batch_gated_bf16(
                    parallel.shard_batched_model(
                        parallel.stack_models(glms32), mesh))
            _save_post(out, f"{key}/gated", post, n_iter)
            out[f"{key}/gated/conv"] = conv.numpy()
        ep = solvers["ep"][1]
        from tramp_tpu_torch.algos import CustomInit
        out[f"{key}/error_list"] = np.array(_error(
            lambda: parallel.solve_batch_shard_map(
                ep, stacked, mesh,
                initializer=[CustomInit(a_init=[("x", "bwd", 1.0)])] * 8)))
        if shape[0] > 1:
            odd = parallel.stack_models(glms[:7])
            out[f"{key}/error_odd"] = np.array(_error(
                lambda: parallel.solve_batch_shard_map(ep, odd, mesh)))


def complex_chain(torch, tt, data):
    """The port's students of the complex chain in ``data``: a real prior on
    a packed (2, N) variable, a ``UnitaryChannel`` Q, a
    ``ComplexLinearChannel`` F per lane, Gaussian noise on the packed
    output."""
    from tramp_tpu_torch.channels import (
        ComplexLinearChannel, GaussianChannel, UnitaryChannel)
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    kw = dict(device="cpu", dtype=torch.float64)
    Q = data["cx_Q_re"] + 1j * data["cx_Q_im"]
    models = []
    for F, y in zip(data["cx_F_re"] + 1j * data["cx_F_im"], data["cx_y"]):
        m = (GaussBernoulliPrior(size=(2, F.shape[1]), rho=0.5, **kw)
             @ tt.V(id="x") @ UnitaryChannel(Q, **kw) @ tt.V(id="u")
             @ ComplexLinearChannel(F, **kw) @ tt.V(id="z")
             @ GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
        models.append(m.to_observed({"y": torch.as_tensor(y, **kw)}))
    return models


def complex_solves(torch, tt, parallel, world, data, out):
    """The complex chain's EP batch sharded on each mesh of this world, and
    the operator bytes of its two complex channels on the rank."""
    models = complex_chain(torch, tt, data)
    solver = parallel.EPSolver(models[0], **EP_COMPLEX)
    stacked = parallel.stack_models(models)
    for shape in MESHES[world]:
        mesh = parallel.make_mesh(shape, device="cpu")
        key = "x".join(map(str, shape))
        sharded = parallel.shard_batched_model(stacked, mesh)
        _save_post(out, f"{key}/complex", *solver.solve_batch(sharded))
        out[f"{key}/bytes"] = np.array([
            [sum(f._buffers[k].nbytes for k in f._model_split_fields)
             for f in model.factors[1:3]] for model in (sharded, stacked)])


def _wait_for(path, timeout=150.0):
    "Wait until the file ``path`` exists (another world writes it)."
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written in {timeout} s")
        time.sleep(0.05)


def grid_checkpoint(torch, tt, parallel, world, data, out, path):
    """The SE grid on a ``(world,)`` data mesh with its rank-0 CSV; the
    elastic checkpoint: written under 4 ranks (after 7 iterations, and the
    uncut solve), restored and resumed under each 2-rank mesh once the
    world of 4, which runs at the same time, has written it."""
    mesh = parallel.make_mesh((world,), ("data",), device="cpu")
    df = parallel.run_se_phase_grid(tt.glm_state_evolution, GRID, mesh=mesh,
                                    device="cpu", **GRID_KW)
    for k in ("alpha", "prior_rho", "v", "n_iter"):
        out[f"grid/{k}"] = df[k].to_numpy()
    out["grid/csv_written"] = np.array(parallel.save_grid_csv(
        df, os.path.join(path, f"grid_{world}.csv")))

    glms = _models(torch, tt, data, "glm")
    stacked = parallel.stack_models(glms)
    inf = float("inf")

    def ep(max_iter, tol=1e-8):
        return parallel.EPSolver(glms[0], damping=0.1, max_iter=max_iter,
                                 tol=tol, rollback_increase=inf)
    if world == 4:
        mesh = parallel.make_mesh((4, 1), device="cpu")
        sharded = parallel.shard_batched_model(stacked, mesh)
        _save_post(out, "4x1/full", *ep(FULL).solve_batch(sharded))
        _, state, n_cut = ep(CUT, tol=1e-12).solve_batch_with_state(sharded)
        out["4x1/n_cut"] = n_cut.numpy()
        parallel.save_checkpoint(os.path.join(path, "ckpt"), state, n_cut)
        # the same state as each rank's lanes: gathered before it is written
        parallel.save_checkpoint(
            os.path.join(path, "ckpt_parts"),
            parallel.shard_batched_state(state, mesh), n_cut)
        return
    _wait_for(os.path.join(path, "ckpt", "checkpoint.npz"))
    for shape in MESHES[2]:
        mesh = parallel.make_mesh(shape, device="cpu")
        key = "x".join(map(str, shape))
        sharded = parallel.shard_batched_model(stacked, mesh)
        # a template of this mesh's lanes, from a state of the batch's
        # structure
        _, like, n_like = ep(1).solve_batch_with_state(sharded)
        template = parallel.shard_batched_state(like, mesh)
        state, n_cut = parallel.restore_checkpoint(
            os.path.join(path, "ckpt"), like=(template, n_like))
        leaves = parallel.checkpoint._flatten(state, "", {})
        for k, v in leaves.items():
            out[f"{key}/restored{k}"] = v.numpy()
        out[f"{key}/n_cut"] = n_cut.numpy()
        _save_post(out, f"{key}/resumed",
                   *ep(FULL - CUT).solve_batch(sharded, state=state))


def main():
    scenario, rank, world, port, path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    import tramp_tpu_torch as tt
    from tramp_tpu_torch import parallel
    with np.load(os.path.join(path, "inputs.npz")) as f:
        data = {k: f[k] for k in f.files}
    out = {}
    if scenario == "solvers":
        solvers(torch, tt, parallel, world, data, out)
    elif scenario == "complex":
        complex_solves(torch, tt, parallel, world, data, out)
    else:
        grid_checkpoint(torch, tt, parallel, world, data, out, path)
    np.savez(os.path.join(path, f"rank{rank}_of_{world}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
