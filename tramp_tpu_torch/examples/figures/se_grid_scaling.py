"""Scaling of the batched solves over a device mesh: FLOPs per process of
a batched EP solve and the SE phase grid's points per second.

Counterpart of examples/figures/se_grid_scaling.py (SURVEY.md §2.10 /
§5.8). Two measurements on the mesh of the ``torch.distributed`` world
(a world of this one process unless a launcher such as ``torchrun`` made a
larger one; run it once per world size to read the scaling):

1. **FLOPs per process of one sharded batched EP solve** (16 instances of
   an N = 512 compressed-sensing GLM, float32), counted by
   ``torch.utils.flop_counter.FlopCounterMode`` over every iteration the
   solve runs on this process. The counter counts the products torch
   dispatches (mm, bmm, matmul and the like) and no elementwise operation,
   so it is not the figure the JAX script reads from XLA's cost analysis
   (``comp.cost_analysis()``, which counts the elementwise work of the
   compiled loop body too): the two are different numbers.
2. **SE phase-grid points/s** (128 points, float64), the best of 3 timed
   solves after a warm-up.

Then the grid's CSV through ``run_se_phase_grid(..., mesh=...)`` (rank 0
writes it). Writes se_grid_scaling.json and se_grid_scaling.csv to
``--out``.

Run: python -m tramp_tpu_torch.examples.figures.se_grid_scaling
[--device cpu] [--out DIR]
"""
import json
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

import tramp_tpu_torch as tt
from tramp_tpu_torch import glm_state_evolution
from tramp_tpu_torch.priors import GaussBernoulliPrior
from tramp_tpu_torch.channels import LinearChannel, GaussianChannel
from tramp_tpu_torch.algos import CustomInit
from tramp_tpu_torch.parallel import (
    EPSolver, SESolver, stack_models, make_mesh, shard_batched_model,
    grid_combos, run_se_phase_grid, save_grid_csv)
from tramp_tpu_torch.examples import _cli

GRID = dict(alpha=np.linspace(0.05, 1.0, 64), prior_rho=[0.25, 0.5])
MODEL = dict(prior_type="gauss_bernoulli", output_type="gaussian",
             output_var=1e-11)


def _build_ep(N, alpha, generator, device):
    M = int(alpha * N)
    W = torch.randn((M, N), generator=generator, device=device) / \
        math.sqrt(N)
    teacher = (GaussBernoulliPrior(size=N, rho=0.25, device=device)
               @ tt.V(id="x") @ LinearChannel(W, name="W") @ tt.V(id="z")
               @ GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
    s = teacher.sample(generator)
    return teacher.to_observed({"y": s["y"]})


def flops_per_process(mesh, device, N=512, batch=16):
    """FLOPs that FlopCounterMode counts over one sharded batched EP solve
    on this process (products only)."""
    models = [_build_ep(N, 0.5, _cli.generator(device, i), device)
              for i in range(batch)]
    sharded = shard_batched_model(stack_models(models), mesh)
    solver = EPSolver(models[0], damping=0.1, max_iter=50, tol=1e-8)
    with FlopCounterMode(display=False) as counter:
        solver.solve_batch(sharded)
    return float(counter.get_total_flops())


def se_points_per_s(mesh, device, repeats=3):
    "Steady-state SE grid points/s on the mesh (warm-up excluded)."
    combos = grid_combos(GRID)
    models = [glm_state_evolution(**{k: float(v) for k, v in kw.items()},
                                  **MODEL) for kw in combos]
    models = models + [models[-1]] * ((-len(models)) % mesh.size(0))
    stacked = shard_batched_model(stack_models(models, device=device), mesh)
    solver = SESolver(models[0], tol=1e-6, max_iter=200, device=device)
    init = CustomInit(a_init=[("x", "bwd", 0.0)])
    best = float("inf")
    for i in range(repeats + 1):   # the first is the warm-up
        t0 = time.perf_counter()
        post, n_iter = solver.solve_batch(stacked, initializer=init)
        n_iter.cpu()
        if i:
            best = min(best, time.perf_counter() - t0)
    return len(combos) / best


def main(argv=None):
    args = _cli.parser(__doc__).parse_args(argv)
    device = _cli.device(args)
    out = _cli.out_dir(args, "figures")
    made = not dist.is_initialized()
    mesh = make_mesh(None, ("data", "model"), device=device.type)
    try:
        n = mesh.size(0)
        flops = flops_per_process(mesh, device)
        print(f"{n} process(es): {flops:.3e} FLOPs per process "
              "(FlopCounterMode: products only)")
        pps = se_points_per_s(mesh, device)
        print(f"{n} process(es): {pps:.2f} SE points/s")
        report = {
            "processes": n,
            "flop_counter_flops_per_process": flops,
            "flop_counter_note": (
                "torch.utils.flop_counter.FlopCounterMode over one batched "
                "EP solve: products only, not XLA's cost analysis"),
            "se_grid_points": len(grid_combos(GRID)),
            "se_points_per_s": pps,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "physical_cores": os.cpu_count(),
        }
        print(json.dumps(report))
        # grid CSV artifact through the rank-0 aggregation path
        df = run_se_phase_grid(glm_state_evolution, GRID, ids=("x",),
                               a0=0.0, mesh=mesh, device=device, **MODEL)
        if dist.get_rank() == 0:
            with open(os.path.join(out, "se_grid_scaling.json"), "w") as f:
                json.dump(report, f, indent=1)
        save_grid_csv(df, os.path.join(out, "se_grid_scaling.csv"))
    finally:
        if made:
            dist.destroy_process_group()
    return report, df


if __name__ == "__main__":
    main()
