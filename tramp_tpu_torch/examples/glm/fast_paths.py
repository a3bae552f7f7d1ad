"""Production fast paths: dispatch_solver and the gated bf16 solve.

Counterpart of examples/glm/fast_paths.py, on two models:

1. a compressed-sensing GLM: ``dispatch_solver`` routes it to
   ``SpectralVAMPSolver`` (the LMMSE step entirely in the SVD basis);
2. a two-layer relu network: ``dispatch_solver`` routes it to
   ``MLVAMPSolver``, whose relu factor runs the hand-written message
   kernels on the card (``csrc/pl_message.cu``: one forward and one
   backward launch per iteration);

and the two-phase convergence-gated solve (``solve_gated_bf16``): sweeps
with the message state stored in bfloat16 to a coarse gate, one upcast,
then float32 sweeps to tol 1e-6. Float32 throughout, as the JAX script.
The data come from ``np.random.RandomState`` as in the JAX script; the
GLM's teacher sample from a ``torch.Generator``.

Run: python -m tramp_tpu_torch.examples.glm.fast_paths [--device cpu]
(reference protocol analog: examples/figures/compute_benchmark.py:16-70;
no fast path exists there).
"""
import numpy as np
import torch

import tramp_tpu_torch as tt
from tramp_tpu_torch.priors import GaussBernoulliPrior
from tramp_tpu_torch.channels import (
    LinearChannel, GaussianChannel, ReluChannel)
from tramp_tpu_torch.parallel import (
    EPSolver, dispatch_solver, SpectralVAMPSolver, MLVAMPSolver)
from tramp_tpu_torch.examples import _cli

F32 = torch.float32
SOLVE = dict(max_iter=300, tol=1e-6)


def build_glm(device, N=1000, alpha=0.5, rho=0.25, noise=1e-2, seed=0):
    "(student, x0): W from RandomState(seed), the teacher sampled."
    rng = np.random.RandomState(seed)
    W = rng.randn(int(alpha * N), N) / np.sqrt(N)
    teacher = (
        GaussBernoulliPrior(size=N, rho=rho, device=device, dtype=F32)
        @ tt.V(id="x") @ LinearChannel(W, device=device, dtype=F32)
        @ tt.V(id="z") @ GaussianChannel(var=noise) @ tt.O(id="y")
    ).to_model()
    sample = teacher.sample(_cli.generator(device, seed + 1))
    student = teacher.to_observed({"y": sample["y"].to(F32)})
    return student, sample["x"].double().cpu().numpy()


def build_relu_net(device, N=1024, alpha=0.5, rho=0.25, noise=1e-2, seed=1):
    "(student, x0), all from RandomState(seed)."
    rng = np.random.RandomState(seed)
    W = rng.randn(int(alpha * N), N) / np.sqrt(N)
    x0 = (rng.rand(N) < rho) * rng.randn(N)
    y = np.maximum(W @ x0, 0.0) + np.sqrt(noise) * rng.randn(int(alpha * N))
    student = (
        GaussBernoulliPrior(size=N, rho=rho, device=device, dtype=F32)
        @ tt.V(id="x") @ LinearChannel(W, name="W", device=device, dtype=F32)
        @ tt.V(id="z") @ ReluChannel() @ tt.V(id="a")
        @ GaussianChannel(var=noise) @ tt.O(id="y")
    ).to_model().to_observed(
        {"y": torch.as_tensor(y, device=device, dtype=F32)})
    return student, x0


def _mse(post, x0):
    r = post["x"]["r"].double().cpu().numpy()
    return float(np.mean((r - x0) ** 2))


def run_glm(student, x0):
    """The GLM dispatched (a SpectralVAMPSolver) and through the engine's
    EPSolver as control. Returns (row, the control EPSolver, its post)."""
    solver = dispatch_solver(student, **SOLVE)
    post, n_iter = solver.solve(student)
    ep = EPSolver(student, damping=0.1, **SOLVE)
    post_ep, n_iter_ep = ep.solve(student)
    row = dict(solver=type(solver).__name__, n_iter=int(n_iter),
               mse=_mse(post, x0), v=_cli.mean(post["x"]["v"]),
               n_iter_engine=int(n_iter_ep), mse_engine=_mse(post_ep, x0),
               v_engine=_cli.mean(post_ep["x"]["v"]))
    return row, ep, post_ep


def run_relu(student, x0):
    "The relu net dispatched (an MLVAMPSolver)."
    solver = dispatch_solver(student, damping=0.1, **SOLVE)
    post, n_iter = solver.solve(student)
    return dict(solver=type(solver).__name__, n_iter=int(n_iter),
                mse=_mse(post, x0), v=_cli.mean(post["x"]["v"]))


def run_gated(ep, student, post_f32):
    "The gated bf16 solve of the GLM against the float32 solve's v."
    post_g, n_tot, conv, info = ep.solve_gated_bf16(student)
    v_g, v_f = _cli.mean(post_g["x"]["v"]), _cli.mean(post_f32["x"]["v"])
    return dict(info, n_iter=int(n_tot), conv=bool(conv), v=v_g,
                v_rel_err_vs_f32=abs(v_g - v_f) / v_f)


def main(argv=None):
    args = _cli.parser(__doc__).parse_args(argv)
    device = _cli.device(args)
    # 1. GLM: dispatched -> SpectralVAMP; engine as control
    student, x0 = build_glm(device)
    glm, ep, post_ep = run_glm(student, x0)
    assert glm["solver"] == SpectralVAMPSolver.__name__, glm["solver"]
    print(f"GLM    dispatch={glm['solver']:<20} n_iter={glm['n_iter']:3d} "
          f"mse={glm['mse']:.5f} (engine mse={glm['mse_engine']:.5f})")

    # 2. relu net: dispatched -> MLVAMP
    relu_student, x0r = build_relu_net(device)
    relu = run_relu(relu_student, x0r)
    assert relu["solver"] == MLVAMPSolver.__name__, relu["solver"]
    print(f"relu   dispatch={relu['solver']:<20} n_iter={relu['n_iter']:3d} "
          f"mse={relu['mse']:.5f}")

    # 3. gated bf16 throughput mode: tol=1e-6 convergence with bf16 sweeps
    gated = run_gated(ep, student, post_ep)
    print(f"gated  bf16_sweeps={gated['n_iter_bf16']} "
          f"f32_polish={gated['n_iter_f32']} conv={gated['conv']} "
          f"v_rel_err_vs_f32={gated['v_rel_err_vs_f32']:.2e}")
    return dict(glm=glm, relu=relu, gated=gated)


if __name__ == "__main__":
    main()
