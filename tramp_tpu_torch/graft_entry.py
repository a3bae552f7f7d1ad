"""Entry points of a run. Counterpart of the JAX package's root module
``__graft_entry__.py``, with the same names.

- ``entry()``: one EP sweep (forward + backward message pass) of the
  flagship compressed-sensing GLM, one card;
- ``dryrun_multichip(n)``: the batched, sharded EP solve end to end over a
  mesh of ``n`` processes (data parallelism over problem instances x model
  parallelism over the sensing matrix), in four stages.

Everything runs on the card unless the caller passes ``device="cpu"``, in
float32 there and in float64 on the CPU (the JAX package turns x64 on for
its virtual CPU mesh only). PyTorch runs eagerly, so ``entry``'s ``fn`` is
one eager sweep, not a compiled one.

The mesh is a ``torch.distributed`` world with one process per device
(``parallel.make_mesh``): ``nccl`` on cards, ``gloo`` on the CPU. Without a
process group or a launcher's environment ``dryrun_multichip(1)`` makes a
world of this one process; for more, start one process per device, e.g.::

    torchrun --nproc-per-node=4 --no-python python3 -c \\
        "from tramp_tpu_torch.graft_entry import dryrun_multichip; \\
         dryrun_multichip(4)"
"""
import math
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .algos import ExpectationPropagation, StateEvolution
from .channels import GaussianChannel, LinearChannel
from .config import default_device
from .models import glm_state_evolution
from .parallel import (
    EPSolver, make_mesh, run_se_phase_grid, save_grid_csv,
    shard_batched_model, stack_models,
)
from .parallel.mesh import axis_size
from .priors import GaussBernoulliPrior
from .variables import O, V

#: every teacher is sampled from this seed (the JAX side's PRNGKey(1))
SAMPLE_SEED = 1
#: set on every operator seed, so that no operator's generator shares the
#: sample's stream
OPERATOR_STREAM = 1 << 63


def _device(device):
    "``device`` as a torch.device; None is the first card (raises without)."
    return default_device() if device is None else torch.device(device)


def _dtype(device):
    "float64 on the CPU, float32 on a card."
    return torch.float64 if device.type == "cpu" else torch.float32


def _generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _split(seed, n):
    """``n`` operator seeds from ``seed`` (the JAX side's
    ``jax.random.split``), each with ``OPERATOR_STREAM`` set."""
    return [int(s.generate_state(1, np.uint64)[0]) | OPERATOR_STREAM
            for s in np.random.SeedSequence(seed).spawn(n)]


def _check(ok, what):
    "Raise where a stage's assertion fails (``assert`` goes under -O)."
    if not ok:
        raise AssertionError(what)


def _say(line):
    "One line of the dryrun, printed by rank 0 only."
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(line, flush=True)


def _glm(prior_size, linear, rho, noise_var, device, dtype):
    return (
        GaussBernoulliPrior(size=prior_size, rho=rho, device=device,
                            dtype=dtype) @ V(id="x") @
        linear @ V(id="z") @
        GaussianChannel(var=noise_var) @ O(id="y")
    ).to_model()


def _build_glm(N, alpha, generator_or_seed, rho=0.25, noise_var=1e-2,
               device=None, dtype=None):
    """The student of a compressed-sensing GLM: W ~ N(0, 1/N) of shape
    (int(alpha N), N), drawn from ``generator_or_seed`` (a torch.Generator
    on ``device``, or a seed, taken with ``OPERATOR_STREAM`` set); the
    teacher is sampled from ``SAMPLE_SEED``, so all instances share one x,
    as on the JAX side."""
    device = _device(device)
    dtype = dtype or _dtype(device)
    g = generator_or_seed
    if not isinstance(g, torch.Generator):
        g = _generator(device, int(g) | OPERATOR_STREAM)
    M = int(alpha * N)
    W = torch.randn((M, N), generator=g, device=device,
                    dtype=dtype) / math.sqrt(N)
    teacher = _glm(N, LinearChannel(W, name="W"), rho, noise_var, device,
                   dtype)
    sample = teacher.sample(_generator(device, SAMPLE_SEED))
    return teacher.to_observed({"y": sample["y"]})


def entry(device=None):
    """Returns (fn, example_args): ``fn(model, state)`` is one EP sweep
    (forward + backward message pass, damping 0.1) of the flagship
    compressed-sensing GLM (N = 1024, alpha 0.5), and returns the new
    state; the example arguments are the student and the engine's initial
    state. ``fn`` derives the carried spectral image from ``model``'s
    operator before it sweeps, as the engine's ``iterate`` does at the start
    of a run (between sweeps that gives the carried bits again), so ``fn``
    applied ``k`` times is ``iterate(max_iter=k, tol=0)``."""
    device = _device(device)
    student = _build_glm(N=1024, alpha=0.5, generator_or_seed=0,
                         device=device, dtype=_dtype(device))
    engine = ExpectationPropagation(student)
    state = engine.init_state()
    damp = engine._damping_per_slot(0.1)

    def fn(model, state):
        if engine.spectral_factors:
            state = engine._refresh_spectral_cache(state, model)
        return engine._sweep(model, state, damp, engine._prepare(model))

    return fn, (student, state)


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _operators(model):
    "The dense operators of a model: what the model axis splits."
    return [f._buffers[name] for f in model.factors
            for name in getattr(f, "_model_split_fields", ())
            if f._buffers.get(name) is not None]


def _timed_svd(W):
    t0 = time.perf_counter()
    U, s, Vt = np.linalg.svd(W, full_matrices=True)
    return U, s, Vt, time.perf_counter() - t0


def _host_svd(W):
    """``np.linalg.svd(W, full_matrices=True)``, cached in the temporary
    directory: rank 0 computes and writes the file, and the other ranks
    read it after a barrier (a rank that does not find it, on another
    host, computes its own). Returns (U, s, Vt, seconds of the SVD, None
    where it was read)."""
    M, N = W.shape
    path = os.path.join(tempfile.gettempdir(),
                        f"tramp_tpu_torch_graft_svd_{M}x{N}.npz")
    rank = dist.get_rank() if dist.is_initialized() else 0
    done = None
    if rank == 0 and not os.path.exists(path):
        done = _timed_svd(W)
        part = f"{path}.{os.getpid()}.npz"
        np.savez(part, U=done[0], s=done[1], Vt=done[2])
        os.replace(part, path)
    if dist.is_initialized():
        dist.barrier()
    if done is None and os.path.exists(path):
        with np.load(path) as d:
            done = d["U"], d["s"], d["Vt"], None
    return done or _timed_svd(W)


def _dryrun_model_parallel(n_devices, N=4096, alpha=0.5, rho=0.25,
                           noise_var=1e-2, device=None):
    """One GLM instance whose operators W (M x N), U (M x k) and V (N x k),
    k = M, about 84 MB in float32 at N = 4096 (W 33.6 MB, U 16.8 MB, V 33.6
    MB), are split over the whole ``model`` axis of a (1, n_devices) mesh:
    the regime the axis exists for. W is ``RandomState(0)``'s, its SVD is
    computed on the host, full_matrices as on the JAX side, and cached
    (``_host_svd``); the teacher is sampled from seed 2. Checks
    ``_model_parallel``'s (a) and (b), and

    (c) that the sharded solve reaches State Evolution's prediction: v
        within 0.1 and the MSE within 0.25 (the finite-N band) of v_SE.

    Returns the readings as a dict."""
    device = _device(device)
    dtype = _dtype(device)
    mesh = make_mesh((1, n_devices), ("data", "model"), device=device.type)
    M = int(alpha * N)
    W = np.random.RandomState(0).randn(M, N) / np.sqrt(N)
    U, s, Vt, svd_s = _host_svd(W)
    linear = LinearChannel(W, svd=(U, s, Vt), name="W", device=device,
                           dtype=dtype)
    teacher = _glm(N, linear, rho, noise_var, device, dtype)
    sample = teacher.sample(_generator(device, 2))
    student = teacher.to_observed({"y": sample["y"]})
    r, _ = _model_parallel(student, sample["x"], mesh, alpha, rho, noise_var)

    v, mse, v_se = r["v"], r["mse"], r["v_se"]
    _check(abs(v - v_se) / v_se < 0.1, f"stage 4 (c): v {v}, v_SE {v_se}")
    _check(abs(mse - v_se) / v_se < 0.25,
           f"stage 4 (c): mse {mse}, v_SE {v_se} (finite-N band)")
    svd = ("read from the cache" if svd_s is None
           else f"{svd_s:.2f} s on the host")
    placement = "" if r["placed"] is None else (
        f", allocated by the placement {r['placed'] / 1e6:.1f} MB")
    _say(f"dryrun_multichip stage4 OK: N={N} model-parallel x{n_devices}, "
         f"operator bytes/device {r['per_dev'] / 1e6:.1f} MB = "
         f"1/{r['ratio']:.2f} of replicated "
         f"{r['total_op_bytes'] / 1e6:.1f} MB, tensor bytes of the solve "
         f"{r['arg_bytes'] / 1e6:.1f} MB/device{placement}, converged "
         f"n_iter={r['n_iter']} v={v:.5f} vs SE {v_se:.5f}, "
         f"mse={mse:.5f} (SVD {svd})")
    return dict(r, svd_s=svd_s)


def _model_parallel(student, x, mesh, alpha, rho, noise_var):
    """Stage 4's solve of ``student``, whose teacher drew ``x``, with its
    operators split over the whole ``model`` axis of ``mesh``, and State
    Evolution's v_SE. Checks that

    (a) this rank holds 1/n of the operators' bytes (counted from the
        tensors' own ``element_size()``, whole and on the rank);
    (b) the bytes that the solve takes on this rank, every buffer of the
        sharded model and the initial state, stay below the operators'
        share plus 32 MB; on a card, so does ``torch.cuda.memory_allocated()``
        by the placement of the sharded model. These are the tensors' bytes,
        not a compiler's figure (the JAX side reads XLA's memory analysis).

    Returns (the readings as a dict, the sharded solve's posteriors)."""
    n_devices = axis_size(mesh, "model")
    device = x.device
    stacked = stack_models([student])
    on_card = device.type == "cuda"
    before = torch.cuda.memory_allocated() if on_card else 0
    sharded = shard_batched_model(stacked, mesh)
    placed = torch.cuda.memory_allocated() - before if on_card else None

    # (a) the operator bytes on this rank against the whole
    total_op_bytes = _nbytes(_operators(stacked))
    per_dev = _nbytes(_operators(sharded))
    ratio = total_op_bytes / per_dev
    _check(ratio > 0.9 * n_devices, f"stage 4 (a): ratio {ratio} for "
                                    f"{n_devices} devices")

    # (b) the bytes of every tensor the solve takes on this rank
    solver = EPSolver(student, damping=0.1, max_iter=200, tol=1e-7)
    state = solver._with_lanes(solver.init_state(), 1)
    arg_bytes = (_nbytes(b for f in sharded.factors for b in f.buffers())
                 + _nbytes(t for msg in state for t in msg.values()))
    limit = total_op_bytes / n_devices + 32e6
    _check(arg_bytes < limit, f"stage 4 (b): {arg_bytes} bytes on the rank "
                              f"(limit {limit})")
    _check(placed is None or placed < limit,
           f"stage 4 (b): {placed} bytes allocated on the card by the "
           f"placement (limit {limit})")
    del stacked

    post, n_iter = solver.solve_batch(sharded)
    se = StateEvolution(glm_state_evolution(
        alpha=alpha, prior_type="gauss_bernoulli", output_type="gaussian",
        prior_rho=rho, output_var=noise_var), device=device)
    se.iterate(max_iter=500)
    readings = dict(
        N=x.shape[-1], ratio=ratio, per_dev=per_dev,
        total_op_bytes=total_op_bytes, arg_bytes=arg_bytes, placed=placed,
        n_iter=int(n_iter[0]), v=float(post["x"]["v"][0].double().mean()),
        mse=float(((post["x"]["r"][0] - x).double() ** 2).mean()),
        v_se=float(se.get_variable_data("x")["v"].double().mean()))
    return readings, post


def _stage1(mesh, data_par, device, dtype):
    "One EP step of 2 instances per data rank at N = 32 on ``mesh``."
    N = 32
    n_instances = 2 * data_par
    models = [_build_glm(N, 0.5, seed, device=device, dtype=dtype)
              for seed in _split(0, n_instances)]
    stacked = shard_batched_model(stack_models(models), mesh)
    solver = EPSolver(models[0], damping=0.1, max_iter=1, tol=0.0)
    post, _ = solver.solve_batch(stacked)
    r = post["x"]["r"]
    _check(tuple(r.shape) == (n_instances, N), f"stage 1: r {r.shape}")
    _check(bool(torch.isfinite(r).all()), "stage 1: r not finite")
    _say(f"dryrun_multichip stage1 OK: mesh="
         f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} instances="
         f"{n_instances} N={N} r.shape={tuple(r.shape)}")


def _stage2(models, mesh):
    """The converged solve of ``models`` sharded on ``mesh`` against the
    unsharded solve of ``models[0]`` in this process: r and v at rtol 1e-6,
    equal n_iter (in float32 tol 1e-8 lies below the stop metric's floor,
    and both run to max_iter). Returns the sharded (post, n_iter)."""
    stacked = shard_batched_model(stack_models(models), mesh)
    solver = EPSolver(models[0], damping=0.1, max_iter=200, tol=1e-8)
    post, n_iter = solver.solve_batch(stacked)
    want, want_iter = solver.solve(models[0])
    for key in ("r", "v"):
        np.testing.assert_allclose(
            post["x"][key][0].cpu().numpy(), want["x"][key].cpu().numpy(),
            rtol=1e-6, err_msg=f"stage 2: {key}")
    _check(int(n_iter[0]) == int(want_iter),
           f"stage 2: n_iter {int(n_iter[0])} sharded, {int(want_iter)} "
           "unsharded")
    _say(f"dryrun_multichip stage2 OK: N={post['x']['r'].shape[-1]} "
         f"converged in {n_iter.cpu().tolist()} iters, sharded == "
         "single-device at rtol 1e-6")
    return post, n_iter


def _stage3(n_devices, device):
    """An SE phase grid of 8 n_devices points on the one-axis mesh
    (n_devices,), and its CSV, written by rank 0 alone. Returns the grid
    (a DataFrame) and whether this rank wrote the file."""
    grid_mesh = make_mesh((n_devices,), ("data",), device=device.type)
    t0 = time.perf_counter()
    df = run_se_phase_grid(
        glm_state_evolution,
        grid_kwargs={"alpha": np.linspace(0.05, 1.0, 4 * n_devices),
                     "prior_rho": [0.25, 0.5]},
        ids=("x",), a0=0.0, mesh=grid_mesh, device=device,
        prior_type="gauss_bernoulli", output_type="gaussian",
        output_var=1e-11)
    dt = time.perf_counter() - t0
    _check(len(df) == 8 * n_devices, f"stage 3: {len(df)} grid points")
    _check(bool(np.isfinite(df["v"]).all()), "stage 3: v not finite")
    rank = dist.get_rank()
    with tempfile.TemporaryDirectory() as out:
        path = os.path.join(out, "grid.csv")
        wrote = save_grid_csv(df, path)
        _check(wrote == (rank == 0), f"stage 3: rank {rank} wrote={wrote}")
        if wrote:
            with open(path) as f:
                lines = sum(1 for _ in f)
            _check(lines == len(df) + 1, f"stage 3: {lines} CSV lines")
    _say(f"dryrun_multichip stage3 OK: {len(df)} SE grid points "
         f"({len(df) / dt:.1f} points/s), CSV via rank 0")
    return df, wrote


def dryrun_multichip(n_devices, device=None):
    """Batched + sharded EP over a world of ``n_devices`` processes (one per
    device; the world's size must be ``n_devices``): instances split over
    the "data" axis, the sensing matrix over "model". Four stages, run in
    the order 1, 2, 4, 3; each prints one ``dryrun_multichip stageK OK``
    line and raises where it fails:

    1. one EP step on tiny shapes on the (data, model) mesh, (n/2, 2) for
       an even n, else (n, 1);
    2. a run-to-convergence solve at N = 1024 on that mesh, against the
       unsharded solve (``_stage2``);
    4. ``_dryrun_model_parallel``: N = 4096 on the (1, n) mesh;
    3. a sharded SE phase grid with the rank-0 CSV (``_stage3``)."""
    device = _device(device)
    dtype = _dtype(device)
    model_par = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    data_par = n_devices // model_par
    mesh = make_mesh((data_par, model_par), ("data", "model"),
                     device=device.type)

    _stage1(mesh, data_par, device, dtype)
    models = [_build_glm(1024, 0.5, seed, device=device, dtype=dtype)
              for seed in _split(7, data_par)]
    _stage2(models, mesh)
    _dryrun_model_parallel(n_devices, device=device)
    _stage3(n_devices, device)
