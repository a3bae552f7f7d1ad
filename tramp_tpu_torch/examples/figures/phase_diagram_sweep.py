"""The (alpha, rho) phase diagram as one batched, mesh-sharded SE solve.

Counterpart of examples/figures/phase_diagram_sweep.py. The reference
computes phase diagrams with a sequential loop over grid points
(tramp/experiments/multiple_experiments.py:30-49). Here every (alpha, rho)
point is a lane of one stacked model: alpha is a per-lane hyperparameter
of the Marchenko-Pastur channel and rho of GaussBernoulliPrior, so the
whole grid is one solve, split over the data axis of a device mesh
(``make_mesh`` over ``torch.distributed``: an nccl world on the card, a
gloo world on the CPU; a world of this one process unless a launcher such
as ``torchrun`` made a larger one). Float64. Writes a CSV of (alpha, rho,
v_SE).

Run: python -m tramp_tpu_torch.examples.figures.phase_diagram_sweep
[--big] [--device cpu] [--out DIR]
"""
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from tramp_tpu_torch import glm_state_evolution
from tramp_tpu_torch.parallel import (
    SESolver, stack_models, make_mesh, shard_batched_model)
from tramp_tpu_torch.examples import _cli

SE_SOLVE = dict(max_iter=200, tol=1e-6)


def grid(big):
    "The (alpha, rho) points, alpha the outer loop."
    n_a, n_r = (40, 25) if big else (12, 8)
    return [(a, r) for a in np.linspace(0.05, 1.0, n_a)
            for r in np.linspace(0.05, 0.8, n_r)]


def models_of(points):
    return [glm_state_evolution(
        alpha=a, prior_type="gauss_bernoulli", output_type="gaussian",
        prior_rho=r, output_var=1e-11) for a, r in points]


def solve_grid(points, device, mesh):
    """v_SE of every point, the grid padded to a multiple of the mesh's
    data axis and split over it; returns (v, seconds of the solve)."""
    models = models_of(points)
    n_dev = mesh.size(0)
    # pad the grid to a multiple of the mesh for even sharding
    models = models + models[:(-len(models)) % n_dev]
    padded = shard_batched_model(stack_models(models, device=device), mesh)
    solver = SESolver(models[0], device=device, **SE_SOLVE)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    post, n_iter = solver.solve_batch(padded)
    v = post["x"]["v"].double().cpu().numpy()
    dt = time.perf_counter() - t0
    return v.reshape(len(models), -1).mean(axis=1)[:len(points)], dt


def main(argv=None):
    args = _cli.parser(__doc__, big="40 x 25 points").parse_args(argv)
    device = _cli.device(args)
    points = grid(args.big)
    made = not dist.is_initialized()
    mesh = make_mesh(None, ("data", "model"), device=device.type)
    try:
        n_dev = mesh.size(0)
        v, dt = solve_grid(points, device, mesh)
        print(f"{len(points)} grid points on {n_dev} device(s) in "
              f"{dt:.2f}s ({len(points) / dt:.1f} points/s)")
        csv = os.path.join(_cli.out_dir(args, "figures"),
                           "phase_diagram.csv")
        if dist.get_rank() == 0:
            rows = ["alpha,rho,v_SE"]
            rows += [f"{a},{r},{float(vi)}" for (a, r), vi in zip(points, v)]
            with open(csv, "w") as f:
                f.write("\n".join(rows) + "\n")
            print(f"wrote {csv}")
    finally:
        if made:
            dist.destroy_process_group()
    return dict(points=points, v=v, seconds=dt, devices=n_dev)


if __name__ == "__main__":
    main()
