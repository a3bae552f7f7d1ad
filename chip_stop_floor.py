"""Where the rounding floor of the float32 stop metric comes from, on one
NVIDIA GPU.

    python3 chip_stop_floor.py

``MLVAMPSolver`` and the EP engine stop when the largest relative change of a
posterior mean between two sweeps falls under ``tol``. In float32 that change
never reaches 0: it settles at a floor set by rounding, and a ``tol`` under
the floor never fires. This script reads the floor on chip_smoke.py's relu
net (N = 4096, M = 2048, float32, damping 0.1), always for the same
instance (lane 0 of chip_smoke.py's batch of observations), in every layout
in which the port can run it, and so separates what raises the floor when
lanes are added:

1. the products alone: the error of ``V^T x`` (2-norm, relative to the
   float64 product) through ``LinearChannel._mm`` as a GEMV (no lanes), as
   one GEMM over B lanes that share the operator (``x @ A``), and as a
   ``torch.bmm`` with an operator per lane;
2. the floor: 60 sweeps from the initial state (a solve takes 26), and of
   lane 0's stop metric the median over the last 20 sweeps and the least
   value from the second sweep on (``tol`` fires only if that is under it):
   without lanes; with B = 1, 2, 8, 64, 2048 lanes on one operator; with
   B = 1, 2, 8 lanes that each hold a copy of the operator; and, without
   lanes and with 2048, with every product of the linear factor taken in
   float64 and rounded once ("exact products"), which leaves the elementwise
   code and the kernels as the only float32 arithmetic; and in float64
   without lanes and with 64 lanes, where the floor must vanish if it is
   rounding.

Every line names the card and its power limit. It needs one GPU and imports
nothing of JAX.
"""
import subprocess
import sys

from chip_smoke import (
    LANES, SOLVE, batch_of_observations, check, relu_net, stop_metric_floor)

SWEEPS = 60


def product_errors(torch, linear, card):
    "Phase 1: the rounding of V^T x by layout, for lane 0 and over lanes."
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((LANES, linear.Nz), generator=g, device="cuda",
                    dtype=torch.float32)
    V = linear.V
    exact = x.double() @ V.double()

    def err(got, lanes):
        e = ((got.double() - exact[lanes]).norm(dim=-1)
             / exact[lanes].norm(dim=-1)).reshape(-1)
        return float(e[0]), float(e.median()), float(e.max())

    rows = [("GEMV, no lanes", err(linear._mm(V, x[0], transpose=True),
                                   slice(0, 1)))]
    for B in (1, 2, 8, 64, LANES):
        rows.append((f"GEMM x @ A, {B} lanes on one operator",
                     err(linear._mm(V, x[:B], transpose=True), slice(0, B))))
    for B in (1, 2, 8):
        stacked = V.expand(B, *V.shape).contiguous()
        rows.append((f"torch.bmm, {B} lanes with an operator each",
                     err(linear._mm(stacked, x[:B], transpose=True),
                         slice(0, B))))
    for what, (lane0, median, worst) in rows:
        print(f"product V^T x float32, {what}: relative error of lane 0 "
              f"{lane0:.3e}, median over the lanes {median:.3e}, largest "
              f"{worst:.3e} [{card}]")


def floor_line(torch, what, solver, model, lanes, card):
    history = stop_metric_floor(torch, solver, model, lanes, SWEEPS)
    check(bool(torch.isfinite(history).all()), f"{what}: metric not finite")
    settled = history[-20:].median(0).values
    least = history[1:].amin(0)
    print(f"stop metric, {what}: lane 0 settles at {float(settled[0]):.3e} "
          f"(median of sweeps {SWEEPS - 19} to {SWEEPS}), least from sweep 2 "
          f"on {float(least[0]):.3e}; over the lanes the settled value is "
          f"{float(settled.min()):.3e} to {float(settled.max()):.3e}, the "
          f"least {float(least.min()):.3e} to {float(least.max()):.3e} "
          f"(tol {SOLVE['tol']:g}) [{card}]")


def main():
    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import tramp_tpu_torch as tt
    from tramp_tpu_torch.channels import LinearChannel
    from tramp_tpu_torch.parallel import (
        MLVAMPSolver, dispatch_solver, stack_models, with_buffers)

    student, _, linear = relu_net(torch, tt, torch.float32)
    likelihood = len(student.factors) - 1
    _, ys = batch_of_observations(torch, linear.W, LANES, True, seed=4)
    solver = dispatch_solver(student, **SOLVE)
    check(type(solver) is MLVAMPSolver, type(solver).__name__)

    def single(model, y):
        return with_buffers(model, {(likelihood, "y"): y})

    product_errors(torch, linear, card)

    floor_line(torch, "float32, no lanes (GEMV)", solver,
               single(student, ys[0]), None, card)
    for B in (1, 2, 8, 64, LANES):
        floor_line(torch, f"float32, {B} lanes on one operator (GEMM x @ A)",
                   solver, single(student, ys[:B]), B, card)
    for B in (1, 2, 8):
        floor_line(torch, f"float32, {B} lanes with an operator each "
                   "(torch.bmm)", solver,
                   stack_models([single(student, ys[i]) for i in range(B)]),
                   B, card)

    # every product of the linear factor in float64, rounded once
    plain_mm = LinearChannel._mm
    doubles = {}

    def exact_mm(A, x, transpose=False):
        if id(A) not in doubles:
            doubles[id(A)] = (A, A.double())
        return plain_mm(doubles[id(A)][1], x.double(), transpose).to(x.dtype)

    LinearChannel._mm = staticmethod(exact_mm)
    try:
        floor_line(torch, "float32 with exact products, no lanes", solver,
                   single(student, ys[0]), None, card)
        floor_line(torch, f"float32 with exact products, {LANES} lanes on "
                   "one operator", solver, single(student, ys), LANES, card)
    finally:
        LinearChannel._mm = staticmethod(plain_mm)
        doubles.clear()

    student64, _, _ = relu_net(torch, tt, torch.float64)
    solver64 = dispatch_solver(student64, **SOLVE)
    ys64 = ys.double()
    floor_line(torch, "float64, no lanes", solver64,
               single(student64, ys64[0]), None, card)
    floor_line(torch, "float64, 64 lanes on one operator", solver64,
               single(student64, ys64[:64]), 64, card)
    print("done")


if __name__ == "__main__":
    sys.exit(main())
