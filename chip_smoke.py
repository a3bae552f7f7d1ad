"""Smoke run of tramp_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and no result
line is printed):
1. the device: a CUDA device must be present; prints nvidia-smi's name and
   power limit;
2. builds the CUDA kernel (tramp_tpu_torch/csrc/pl_posterior.cu) from the
   checkout with nvcc and prints the seconds taken and ptxas's report;
3. holds the kernel against its plain PyTorch version on the card for the
   six piecewise-linear channels of tests/test_pallas_ops.py, at n = 2048
   and n = 2**20 + 300, in float64 (rtol 1e-10, as the JAX package's Pallas
   test) and float32 (rtol 1e-4), with CUDA-event times per call of both;
4. the EP engine's main path through the kernel: the relu net
   x -> W -> relu -> + noise -> y at N = 4096, alpha = 0.5, rho = 0.25,
   noise 1e-2 (bench.py:1124-1157), solved with
   ``ExpectationPropagation(student).iterate(max_iter=500, damping=0.1,
   tol=1e-6)`` in float32 and float64 on the card (a warm-up solve, then a
   timed one). It checks that the kernel ran twice per sweep, that the
   outputs are finite, and that float32 and float64 agree on the posterior
   variance and the MSE within 5e-2 (bench.py:118-119); and, at N = 256 in
   float64, that the card's
   solve matches the CPU's (plain version) in n_iter and, at rtol 1e-8, in
   the x posterior;
5. the flagship compressed-sensing GLM at N = 10**4, alpha = 0.5, float32
   (no kernel on this path), with |mse - v| / v < 0.25, the finite-N band
   of __graft_entry__.py:126;
6. a JSON line on the kernel, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It needs one GPU and imports nothing of JAX.
"""
import json
import re
import subprocess
import sys
import time

import numpy as np

RHO, NOISE = 0.25, 1e-2
RTOL = {"float64": 1e-10, "float32": 1e-4}
V_MSE_BOUND = 5e-2     # bench.py:118-119, relu_net f32 vs f64
FLAGSHIP_BAND = 0.25   # __graft_entry__.py:126
SOLVE = dict(max_iter=500, damping=0.1, tol=1e-6)   # bench.py:1157


def check(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr)
        sys.exit(1)


def per_call_ms(fn, calls=20, reps=5):
    """Median over ``reps`` of the CUDA-event time of ``calls`` back-to-back
    calls of ``fn``, per call, in milliseconds: what a caller pays per call,
    host launch overhead included."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def compare_kernel(torch, pl, channels):
    """Phase 3. Returns (max abs error over all cases, kernel ms, plain ms
    at the main path's case: relu, n = 2048, float32)."""
    max_err = 0.0
    main = None
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        for n in (2048, 2**20 + 300):
            for channel in channels:
                rng = np.random.RandomState(n + len(channel.name))
                bz = torch.as_tensor(2 * rng.randn(n), device="cuda",
                                     dtype=dtype)
                bx = torch.as_tensor(2 * rng.randn(n), device="cuda",
                                     dtype=dtype)
                az = torch.tensor(1.7, device="cuda", dtype=dtype)
                ax = torch.tensor(0.9, device="cuda", dtype=dtype)
                specs = channel.region_specs
                got = pl.pl_posterior(az, bz, ax, bx, specs)
                want = pl.pl_posterior_plain(az, bz, ax, bx, specs)
                torch.cuda.synchronize()
                rtol = RTOL[dname]
                worst = 0.0
                for name, g, w in zip(("rz", "vz", "rx", "vx", "logZ"),
                                      got, want):
                    check(bool(torch.isfinite(g).all()),
                          f"{channel.name} {dname} n={n}: kernel {name} "
                          "not finite")
                    err = (g - w).abs()
                    bound = rtol * (w.abs() + w.abs().max())
                    ratio = float((err / bound).max())
                    check(ratio <= 1.0,
                          f"{channel.name} {dname} n={n}: kernel {name} "
                          f"off its plain version by {ratio:.3g} x rtol "
                          f"{rtol:g}")
                    worst = max(worst, ratio)
                    max_err = max(max_err, float(err.max()))
                k_ms = per_call_ms(lambda: pl.pl_posterior(az, bz, ax, bx,
                                                         specs))
                p_ms = per_call_ms(lambda: pl.pl_posterior_plain(
                    az, bz, ax, bx, specs))
                print(f"kernel vs plain: {channel.name:7s} {dname} "
                      f"n={n:8d} err/tol={worst:.2e} (rtol {rtol:g}) "
                      f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms")
                if channel.name == "relu" and n == 2048 and \
                        dtype == torch.float32:
                    main = (k_ms, p_ms)
    return max_err, main


def relu_net(torch, tt, dtype, N=4096, alpha=0.5, device="cuda", svd=None):
    "The relu-net student, data from np.random.RandomState(11)."
    from tramp_tpu_torch.channels import (
        GaussianChannel, LinearChannel, ReluChannel)
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    M = int(alpha * N)
    rng = np.random.RandomState(11)
    W = rng.randn(M, N) / np.sqrt(N)
    x0 = (rng.rand(N) < RHO) * rng.randn(N)
    y = np.maximum(W @ x0, 0.0) + np.sqrt(NOISE) * rng.randn(M)
    linear = LinearChannel(W, name="W", svd=svd, device=device, dtype=dtype)
    teacher = (
        GaussBernoulliPrior(size=N, rho=RHO, device=device, dtype=dtype)
        @ tt.V(id="x") @ linear @ tt.V(id="z") @ ReluChannel()
        @ tt.V(id="a") @ GaussianChannel(var=NOISE) @ tt.O(id="y")
    ).to_model()
    y = torch.as_tensor(y, device=device, dtype=dtype)
    return teacher.to_observed({"y": y}), x0, linear


def solve(torch, tt, pl, student, x0):
    """Solve twice: once to warm up (library handles, lazily loaded
    kernels), then timed, with the kernel's launch count set to 0 just
    before. Returns (engine, mse, v, wall seconds, kernel launches)."""
    ep = tt.ExpectationPropagation(student)
    ep.iterate(**SOLVE)
    torch.cuda.synchronize()
    pl.pl_posterior.launches = 0
    t0 = time.perf_counter()
    ep.iterate(**SOLVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pl.pl_posterior.launches
    x = ep.get_variable_data("x")
    r = x["r"].double().cpu().numpy()
    check(np.isfinite(r).all() and bool(torch.isfinite(x["v"]).all()),
          "non-finite x posterior")
    check(r.shape == x0.shape, f"x posterior shape {r.shape}")
    mse = float(np.mean((r - x0) ** 2))
    return ep, mse, float(x["v"].double().mean()), wall, launches


def main():
    import torch
    # phase 1: the device
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import tramp_tpu_torch as tt
        from tramp_tpu_torch.ops import pl_fused as pl
        from tramp_tpu_torch.channels import (
            SgnChannel, AbsChannel, ReluChannel, LeakyReluChannel,
            HardTanhChannel, SymmetricDoorChannel)
    except ImportError as e:
        check(False, f"tramp_tpu_torch not importable ({e}): run from the "
                     "root of a checkout")

    # phase 2: build
    t0 = time.perf_counter()
    lib_path, log = pl.build()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                            log))
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}; "
          f"ptxas: {len(regs)} kernels, max {max(regs, default=0)} "
          f"registers, {spills} bytes of spill stores in all")

    # phase 3: kernel vs plain
    channels = [SgnChannel(), AbsChannel(), ReluChannel(),
                LeakyReluChannel(slope=0.3), HardTanhChannel(),
                SymmetricDoorChannel(width=0.7)]
    max_err, (k_ms, p_ms) = compare_kernel(torch, pl, channels)

    # phase 4: the relu net through the kernel, f32 and f64
    results = {}
    launches = None
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        student, x0, _ = relu_net(torch, tt, dtype)
        ep, mse, v, wall, n_launch = solve(torch, tt, pl, student, x0)
        check(n_launch == 2 * ep.n_iter > 0,
              f"relu net {dname}: {n_launch} kernel launches for "
              f"{ep.n_iter} sweeps (want 2 per sweep)")
        if launches is None:
            launches = n_launch
        results[dname] = (mse, v)
        print(f"relu net N=4096 {dname}: n_iter={ep.n_iter} mse={mse:.6g} "
              f"v={v:.6g} wall={wall:.3f} s sweeps/s="
              f"{ep.n_iter / wall:.1f} kernel launches={n_launch} "
              f"[{card}]")
    (mse32, v32), (mse64, v64) = results["float32"], results["float64"]
    v_rel, mse_rel = abs(v32 - v64) / v64, abs(mse32 - mse64) / mse64
    check(v_rel < V_MSE_BOUND and mse_rel < V_MSE_BOUND,
          f"relu net f32 vs f64: v {v_rel:.3g}, mse {mse_rel:.3g} "
          f"(bound {V_MSE_BOUND})")
    print(f"relu net f32 vs f64: v rel err {v_rel:.3e}, mse rel err "
          f"{mse_rel:.3e} (bound {V_MSE_BOUND})")

    # the card's solve (kernel) against the CPU's (plain) on a small net
    cpu_student, x0, cpu_linear = relu_net(
        torch, tt, torch.float64, N=256, device="cpu")
    svd = (cpu_linear.U, cpu_linear.s, cpu_linear.V.T)
    gpu_student, _, _ = relu_net(torch, tt, torch.float64, N=256, svd=svd)
    cpu_ep = tt.ExpectationPropagation(cpu_student).iterate(**SOLVE)
    gpu_ep = solve(torch, tt, pl, gpu_student, x0)[0]
    r_cpu = cpu_ep.get_variable_data("x")["r"]
    r_gpu = gpu_ep.get_variable_data("x")["r"].cpu()
    r_err = float(((r_gpu - r_cpu).abs()
                   / (r_cpu.abs() + r_cpu.abs().max())).max())
    check(gpu_ep.n_iter == cpu_ep.n_iter and r_err <= 1e-8,
          f"relu net N=256: card n_iter {gpu_ep.n_iter} vs CPU "
          f"{cpu_ep.n_iter}, r err/scale {r_err:.3g} (rtol 1e-8)")
    print(f"relu net N=256 f64, card vs CPU: n_iter {gpu_ep.n_iter} both, "
          f"r rel err {r_err:.3e} (rtol 1e-8)")

    # phase 5: the flagship GLM, float32
    from tramp_tpu_torch.channels import GaussianChannel, LinearChannel
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    N, M = 10_000, 5_000
    rng = np.random.RandomState(0)
    W = rng.randn(M, N) / np.sqrt(N)
    t0 = time.perf_counter()
    linear = LinearChannel(W, name="W", device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    svd_s = time.perf_counter() - t0
    teacher = (
        GaussBernoulliPrior(size=N, rho=RHO, device="cuda",
                            dtype=torch.float32)
        @ tt.V(id="x") @ linear @ tt.V(id="z")
        @ GaussianChannel(var=NOISE) @ tt.O(id="y")
    ).to_model()
    sample = teacher.sample(torch.Generator(device="cuda").manual_seed(1))
    student = teacher.to_observed({"y": sample["y"]})
    ep, mse, v, wall, _ = solve(torch, tt, pl, student,
                                sample["x"].double().cpu().numpy())
    check(abs(mse - v) / v < FLAGSHIP_BAND,
          f"flagship: |mse - v| / v = {abs(mse - v) / v:.3g} "
          f"(band {FLAGSHIP_BAND})")
    print(f"flagship GLM N=10000 float32: n_iter={ep.n_iter} mse={mse:.6g} "
          f"v={v:.6g} |mse-v|/v={abs(mse - v) / v:.3e} wall={wall:.3f} s "
          f"sweeps/s={ep.n_iter / wall:.1f} (SVD {svd_s:.2f} s) [{card}]")

    # phase 6: summary
    print(json.dumps({"kernels": [{
        "name": "pl_posterior", "route": "cuda",
        "source": "tramp_tpu_torch/csrc/pl_posterior.cu",
        "replaces": "tramp_tpu/ops/pl_fused.py:81",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
