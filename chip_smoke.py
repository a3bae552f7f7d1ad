"""Smoke run of tramp_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero and no result
line is printed):
1. the device: a CUDA device must be present; prints nvidia-smi's name and
   power limit;
2. builds the CUDA kernels (tramp_tpu_torch/csrc/pl_posterior.cu and
   pl_message.cu, one nvcc per source and floating type, all at once) from
   the checkout and prints the seconds taken and ptxas's registers and
   spills per instantiation; an instantiation with at most three regions
   (all the repo's channels) must not spill;
3. holds every kernel against its plain PyTorch version on the card for the
   six piecewise-linear channels of tests/test_pallas_ops.py, at n = 2048
   and n = 2**20 + 300, in float64 (rtol 1e-10, as the JAX package's Pallas
   test) and float32 (rtol 1e-4), relative to each element with a floor of
   rtol times the stream's largest magnitude: the five-output posterior
   kernel with CUDA-event times per call of both, and the forward and
   backward message kernels on a_new and b_new, also with per-element
   precisions, with n = 1 and with an n that is no multiple of 4. Then, at
   the main path's case (relu, n = 2048, float32) and in turns (old, new,
   new, old), the composition the sweep ran before the fusion (five-output
   kernel, torch.mean, compute_ab_new) against the fused message: time per
   call (CUDA events), host time per call (unsynchronised calls on the
   host's clock) and kernels launched, beside an empty kernel's launch; and
   each kernel's device time from torch.profiler beside its bound;
4. the EP engine's main path through the kernels: the relu net
   x -> W -> relu -> + noise -> y at N = 4096, alpha = 0.5, rho = 0.25,
   noise 1e-2 (bench.py:1124-1157), solved with
   ``ExpectationPropagation(student).iterate(max_iter=500, damping=0.1,
   tol=1e-6)`` in float32 and float64 on the card (a warm-up solve, then a
   timed one). It checks that each message kernel ran once per sweep and
   the five-output kernel not at all, that the outputs are finite, and that
   float32 and float64 agree on the posterior variance and the MSE within
   5e-2 (bench.py:118-119); reads the relu factor's two posteriors at the
   fixed point through the five-output kernel; counts the kernels of a warm
   sweep and the device's busy share with torch.profiler, with the fused
   messages and, in turns, with the composition they replace; and, at N = 256
   in float64, checks that the card's solve matches the CPU's (plain
   versions) in n_iter and, at rtol 1e-8, in the x posterior, and that two
   solves on the card give the same bits;
5. the flagship compressed-sensing GLM at N = 10**4, alpha = 0.5, float32
   (no kernel on this path), with |mse - v| / v < 0.25, the finite-N band
   of __graft_entry__.py:126;
6. a JSON line on the kernels, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

A kernel's bound is the least time the card could take for the function:
the larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its operations over the peak rate of their type outside
the tensor cores (67 TFLOP/s in float32, half of that in float64; NVIDIA's
H100 SXM data sheet). Operations are counted from the sources (REGION_OPS
below): every addition, multiplication and division and every call of a
special function counts as one, so the count is a lower bound.

It needs one GPU and imports nothing of JAX.
"""
import json
import subprocess
import sys
import time

import numpy as np

RHO, NOISE = 0.25, 1e-2
RTOL = {"float64": 1e-10, "float32": 1e-4}
V_MSE_BOUND = 5e-2     # bench.py:118-119, relu_net f32 vs f64
FLAGSHIP_BAND = 0.25   # __graft_entry__.py:126
SOLVE = dict(max_iter=500, damping=0.1, tol=1e-6)   # bench.py:1157
SIZES = (2048, 2**20 + 300)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 33.5e12}
SOURCES = {"pl_posterior": "tramp_tpu_torch/csrc/pl_posterior.cu",
           "pl_forward_message": "tramp_tpu_torch/csrc/pl_message.cu",
           "pl_backward_message": "tramp_tpu_torch/csrc/pl_message.cu"}

# Operations per element, counted from csrc/pl_common.cuh. Per region: the
# tilted Gaussian, mean, variance, log-partition and weight (region_moments
# without the G functions), then G0, G1, G2 by the interval's kind (the
# cheaper branch where the data decides), the x-side moments, the softmax
# weight, and one side's share of the merge.
REGION_OPS = {"moments": 28, "both_inf": 0, "half_inf": 13, "finite": 25,
              "x_side": 3, "softmax": 4, "merge_side": 7}
ELEMENT_OPS = {"softmax": 1, "merge_side": 3, "logZ": 2,
               "mean_and_update": 4}


def check(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr)
        sys.exit(1)


def dtype_name(dtype):
    return str(dtype).split(".")[1]


def operations(kernel, specs, n):
    "Operations of one call on n elements (see REGION_OPS)."
    per_element = 0
    for zmin, zmax, _, _ in specs:
        infinite = (zmin == -np.inf) + (zmax == np.inf)
        kind = ("finite", "half_inf", "both_inf")[infinite]
        per_element += (REGION_OPS["moments"] + REGION_OPS[kind]
                        + REGION_OPS["softmax"])
        if kernel == "pl_posterior":
            per_element += REGION_OPS["x_side"] + 2 * REGION_OPS["merge_side"]
        else:
            per_element += REGION_OPS["merge_side"]
            if kernel == "pl_forward_message":
                per_element += REGION_OPS["x_side"]
    per_element += ELEMENT_OPS["softmax"]
    if kernel == "pl_posterior":
        per_element += 2 * ELEMENT_OPS["merge_side"] + ELEMENT_OPS["logZ"]
    else:
        per_element += (ELEMENT_OPS["merge_side"]
                        + ELEMENT_OPS["mean_and_update"])
    return per_element * n


def bound_ms(kernel, specs, n, dtype):
    """(bound in ms, "bytes" or "operations", bytes moved) with scalar
    precisions: inputs read once (bz, bx, az, ax), outputs written once
    (five streams, or b_new and a_new)."""
    itemsize = 4 if dtype_name(dtype) == "float32" else 8
    outputs = 5 * n if kernel == "pl_posterior" else n + 1
    moved = (2 * n + 2 + outputs) * itemsize
    by_bytes = moved / HBM_BYTES_PER_S
    by_ops = operations(kernel, specs, n) / PEAK_OPS_PER_S[dtype_name(dtype)]
    which = "bytes" if by_bytes >= by_ops else "operations"
    return 1e3 * max(by_bytes, by_ops), which, moved


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


def host_ms(fn, calls=300):
    """Host time per call in milliseconds: ``calls`` unsynchronised calls on
    the host's clock, the device drained before and after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * elapsed / calls


def profiled(fn, reps):
    """(kernels launched per call, device ms per call, wall ms per call) of
    ``fn`` from torch.profiler over ``reps`` warm calls. The device time is
    the sum of the device-side events (kernels and copies). The profiler now
    and then hands back a window with no device event at all; such a window
    is taken again, at most twice, and the callers fail on a device time of
    0."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    kernels = [e for e in events
               if not e.name.lower().startswith(("memcpy", "memset"))]
    device_us = sum(e.time_range.elapsed_us() for e in events)
    return len(kernels) / reps, 1e-3 * device_us / reps, 1e3 * wall / reps


def inputs(torch, n, dtype, seed, per_element=False):
    rng = np.random.RandomState(seed)
    bz = torch.as_tensor(2 * rng.randn(n), device="cuda", dtype=dtype)
    bx = torch.as_tensor(2 * rng.randn(n), device="cuda", dtype=dtype)
    if per_element:
        az = torch.as_tensor(1.2 + rng.rand(n), device="cuda", dtype=dtype)
        ax = torch.as_tensor(0.4 + rng.rand(n), device="cuda", dtype=dtype)
    else:
        az = torch.tensor(1.7, device="cuda", dtype=dtype)
        ax = torch.tensor(0.9, device="cuda", dtype=dtype)
    return az, bz, ax, bx


def hold(torch, what, names, got, want, rtol):
    """Check every stream of ``got`` against ``want``; returns (worst error
    over tolerance, largest absolute error)."""
    worst, max_err = 0.0, 0.0
    check(len(got) == len(want) == len(names), f"{what}: {len(got)} outputs")
    for name, g, w in zip(names, got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what}: {name} is {tuple(g.shape)} {g.dtype}, plain "
              f"{tuple(w.shape)} {w.dtype}")
        check(bool(torch.isfinite(g).all()), f"{what}: {name} not finite")
        err = (g - w).abs()
        bound = rtol * (w.abs() + w.abs().max())
        ratio = float((err / bound).max())
        check(ratio <= 1.0, f"{what}: {name} off its plain version by "
                            f"{ratio:.3g} x rtol {rtol:g}")
        worst = max(worst, ratio)
        max_err = max(max_err, float(err.max()))
    return worst, max_err


def compare_posterior(torch, pl, channels):
    """Phase 3, five-output kernel. Returns (max abs error over all cases,
    kernel ms, plain ms at the main path's case: relu, n = 2048, float32)."""
    max_err = 0.0
    main = None
    for dtype in (torch.float64, torch.float32):
        dname = dtype_name(dtype)
        for n in SIZES:
            for channel in channels:
                args = inputs(torch, n, dtype, n + len(channel.name))
                specs = channel.region_specs
                got = pl.pl_posterior(*args, specs)
                want = pl.pl_posterior_plain(*args, specs)
                torch.cuda.synchronize()
                worst, err = hold(
                    torch, f"pl_posterior {channel.name} {dname} n={n}",
                    ("rz", "vz", "rx", "vx", "logZ"), got, want, RTOL[dname])
                max_err = max(max_err, err)
                k_ms = per_call_ms(lambda: pl.pl_posterior(*args, specs))
                p_ms = per_call_ms(lambda: pl.pl_posterior_plain(*args,
                                                                 specs))
                print(f"kernel vs plain: {channel.name:7s} {dname} "
                      f"n={n:8d} err/tol={worst:.2e} (rtol {RTOL[dname]:g}) "
                      f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms")
                if channel.name == "relu" and n == 2048 and \
                        dtype == torch.float32:
                    main = (k_ms, p_ms)
    return max_err, main


def compare_messages(torch, pl, channels):
    """Phase 3, message kernels. Returns {wrapper name: max abs error}."""
    pairs = {"pl_forward_message": (pl.pl_forward_message,
                                    pl.pl_forward_message_plain),
             "pl_backward_message": (pl.pl_backward_message,
                                     pl.pl_backward_message_plain)}
    max_err = dict.fromkeys(pairs, 0.0)
    cases = [(n, False, channels) for n in SIZES]
    # per-element precisions, one element, and an n that is no multiple of 4
    cases += [(2048, True, channels[2:5]), (4099, True, channels[2:5]),
              (1, False, channels[2:5]), (4099, False, channels[2:5]),
              (16384, False, channels[2:5]), (16385, False, channels[2:5])]
    for dtype in (torch.float64, torch.float32):
        dname = dtype_name(dtype)
        for n, per_element, some in cases:
            for channel in some:
                args = inputs(torch, n, dtype, n + len(channel.name),
                              per_element)
                specs = channel.region_specs
                line = (f"message vs plain: {channel.name:7s} {dname} "
                        f"n={n:8d} {'a per element' if per_element else ''}")
                for name, (fused, plain) in pairs.items():
                    got = fused(*args, specs)
                    again = fused(*args, specs)
                    want = plain(*args, specs)
                    torch.cuda.synchronize()
                    what = f"{name} {channel.name} {dname} n={n}"
                    worst, err = hold(torch, what, ("a_new", "b_new"), got,
                                      want, RTOL[dname])
                    check(all(torch.equal(g, a) for g, a in zip(got, again)),
                          f"{what}: two calls differ")
                    max_err[name] = max(max_err[name], err)
                    line += f" {name[3:]} err/tol={worst:.2e}"
                print(line)
    return max_err


def time_fusion(torch, pl, base, specs):
    """Phase 3: the composition the sweep ran before the fusion against the
    fused forward message at the main path's case (relu, n = 2048, float32),
    in turns old, new, new, old."""
    az, bz, ax, bx = inputs(torch, 2048, torch.float32, 7)

    def old():
        _, _, rx, vx, _ = pl.pl_posterior(az, bz, ax, bx, specs)
        return base.compute_ab_new(rx, torch.mean(vx), ax, bx)

    def new():
        return pl.pl_forward_message(az, bz, ax, bx, specs)

    got, want = new(), old()
    torch.cuda.synchronize()
    hold(torch, "fused forward message vs composition", ("a_new", "b_new"),
         got, want, RTOL["float32"])
    out = {"old": [], "new": []}
    for name, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
        kernels, device, _ = profiled(fn, 50)
        out[name].append((per_call_ms(fn, calls=100), host_ms(fn), kernels,
                          device))
    floor = (per_call_ms(pl.launch_floor, calls=100),
             host_ms(pl.launch_floor), profiled(pl.launch_floor, 50)[1])
    for name, label in (("old", "posterior kernel + mean + compute_ab_new"),
                        ("new", "fused forward message")):
        for call_ms, h_ms, kernels, device in out[name]:
            print(f"message at relu n=2048 float32, {label}: "
                  f"{1e3 * call_ms:.2f} us per call, {1e3 * h_ms:.2f} us "
                  f"host per call, {kernels:.1f} kernels, "
                  f"{1e3 * device:.2f} us device")
    print(f"empty kernel: {1e3 * floor[0]:.2f} us per call, "
          f"{1e3 * floor[1]:.2f} us host per call, {1e3 * floor[2]:.2f} us "
          "device")
    check(out["new"][0][2] == 1.0, "the fused message at n = 2048 is "
          f"{out['new'][0][2]} kernel launches, want 1")


def kernel_table(torch, pl, channels, card):
    """Phase 3: device time (torch.profiler), time per call (CUDA events) and
    host time per call of every kernel beside its bound, for relu and one
    three-region channel."""
    rows = {}
    wrappers = {"pl_posterior": pl.pl_posterior,
                "pl_forward_message": pl.pl_forward_message,
                "pl_backward_message": pl.pl_backward_message}
    for channel in channels:
        specs = channel.region_specs
        for dtype in (torch.float32, torch.float64):
            for n in SIZES:
                args = inputs(torch, n, dtype, 3)
                for name, fn in wrappers.items():
                    def call():
                        return fn(*args, specs)
                    kernels, device, _ = profiled(call, 20)
                    check(device > 0, "torch.profiler shows no device time")
                    b_ms, by, moved = bound_ms(name, specs, n, dtype)
                    c_ms, h_ms = per_call_ms(call), host_ms(call, calls=100)
                    rows[name, channel.name, dtype_name(dtype), n] = dict(
                        device_ms=device, per_call_ms=c_ms, host_ms=h_ms,
                        bound_ms=b_ms, bound_by=by)
                    print(f"kernel time: {name:20s} {channel.name:7s} "
                          f"{dtype_name(dtype)} n={n:8d} device "
                          f"{1e3 * device:.2f} us ({kernels:.0f} "
                          f"launches), per call {1e3 * c_ms:.2f} us, host "
                          f"{1e3 * h_ms:.2f} us, bound {1e3 * b_ms:.4f} us "
                          f"by {by} ({moved} B), share "
                          f"{100 * b_ms / device:.2f}% [{card}]")
    return rows


def relu_net(torch, tt, dtype, N=4096, alpha=0.5, device="cuda", svd=None,
             ReluChannel=None):
    """The relu-net student, data from np.random.RandomState(11).
    ``ReluChannel``: another class for the relu factor than the port's."""
    from tramp_tpu_torch import channels
    from tramp_tpu_torch.channels import GaussianChannel, LinearChannel
    from tramp_tpu_torch.priors import GaussBernoulliPrior
    ReluChannel = ReluChannel or channels.ReluChannel
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


def reset_launches(pl):
    for fn in (pl.pl_posterior, pl.pl_forward_message,
               pl.pl_backward_message):
        fn.launches = 0


def read_launches(pl):
    return {"pl_posterior": pl.pl_posterior.launches,
            "pl_forward_message": pl.pl_forward_message.launches,
            "pl_backward_message": pl.pl_backward_message.launches}


def solve(torch, tt, pl, student, x0):
    """Solve twice: once to warm up (library handles, lazily loaded
    kernels), then timed, with the kernels' launch counts set to 0 just
    before and read just after. Returns (engine, mse, v, wall seconds,
    launches by kernel)."""
    ep = tt.ExpectationPropagation(student)
    ep.iterate(**SOLVE)
    torch.cuda.synchronize()
    reset_launches(pl)
    t0 = time.perf_counter()
    ep.iterate(**SOLVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(pl)
    x = ep.get_variable_data("x")
    r = x["r"].double().cpu().numpy()
    check(np.isfinite(r).all() and bool(torch.isfinite(x["v"]).all()),
          "non-finite x posterior")
    check(r.shape == x0.shape, f"x posterior shape {r.shape}")
    mse = float(np.mean((r - x0) ** 2))
    return ep, mse, float(x["v"].double().mean()), wall, launches


def read_relu_posteriors(torch, pl, ep):
    """The relu factor's forward and backward posteriors at the engine's
    fixed point, through the channel's own methods: the five-output
    kernel's path. Returns its launches."""
    from tramp_tpu_torch.algos.message_passing import slot, FWD, BWD
    from tramp_tpu_torch.channels import ReluChannel
    i = next(i for i, n in enumerate(ep.nodes) if isinstance(n, ReluChannel))
    fwd = ep.state[slot(ep.model.in_edges[i][0], FWD)]
    bwd = ep.state[slot(ep.model.out_edges[i][0], BWD)]
    args = (fwd["a"], fwd["b"], bwd["a"], bwd["b"])
    reset_launches(pl)
    rx, vx = ep.nodes[i].compute_forward_posterior(*args)
    rz, vz = ep.nodes[i].compute_backward_posterior(*args)
    torch.cuda.synchronize()
    launches = read_launches(pl)["pl_posterior"]
    want = pl.pl_posterior_plain(*args, ep.nodes[i].region_specs)
    rtol = RTOL[dtype_name(rx.dtype)]
    hold(torch, "relu posteriors at the fixed point",
         ("rz", "vz", "rx", "vx"),
         (rz, vz, rx, vx), (want[0], want[1].mean(), want[2], want[3].mean()),
         rtol)
    check(rx.shape == rz.shape == fwd["b"].shape and vx.ndim == vz.ndim == 0,
          "relu posteriors: shapes")
    return launches


def sweep_window(ep, sweeps=10):
    """torch.profiler over ``sweeps`` warm sweeps from the engine's fixed
    point (tol=0: the stop rule never fires; one iterate call of as many
    sweeps warms up first). Returns (kernels, device ms, wall ms), each per
    sweep."""
    before = ep.n_iter
    kernels, device, wall_ms = profiled(
        lambda: ep.iterate(max_iter=sweeps, warm_start=True, tol=0.0), 1)
    check(ep.n_iter - before == 2 * sweeps,
          f"the profiled window ran {ep.n_iter - before} sweeps")
    check(device > 0, "torch.profiler shows no device time")
    return kernels / sweeps, device / sweeps, wall_ms / sweeps


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
        from tramp_tpu_torch import base
        from tramp_tpu_torch.channels.base_channel import Channel
        from tramp_tpu_torch.ops import pl_fused as pl
        from tramp_tpu_torch.channels import (
            SgnChannel, AbsChannel, ReluChannel, LeakyReluChannel,
            HardTanhChannel, SymmetricDoorChannel)
    except ImportError as e:
        check(False, f"tramp_tpu_torch not importable ({e}): run from the "
                     "root of a checkout")

    # phase 2: build
    t0 = time.perf_counter()
    lib_paths, log = pl.build()
    report = pl.ptxas_report(log)
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(p.name for p in lib_paths)}")
    for row in report:
        print(f"ptxas: {row['kernel']}<{row['dtype']}, "
              f"{', '.join(map(str, row['params']))}> "
              f"{row['registers']} registers, {row['spill_bytes']} "
              "bytes of spill stores")
        check(row["spill_bytes"] == 0 or row["params"][0] > 3,
              f"{row['kernel']} {row['dtype']} {row['params']} spills")
    if log:
        check(len(report) >= 3 * 2 * 8,
              f"ptxas reported {len(report)} kernels")
        print(f"ptxas: {len(report)} kernels in all, max "
              f"{max(r['registers'] for r in report)} registers, "
              f"{sum(r['spill_bytes'] for r in report)} bytes of spill "
              "stores (instantiations with 4 to 8 regions included)")
    else:
        print("ptxas: no report, the libraries were already built")

    # phase 3: kernels vs plain, and their times
    channels = [SgnChannel(), AbsChannel(), ReluChannel(),
                LeakyReluChannel(slope=0.3), HardTanhChannel(),
                SymmetricDoorChannel(width=0.7)]
    relu, tanh = channels[2], channels[4]
    max_err = {}
    max_err["pl_posterior"], (post_ms, post_plain_ms) = compare_posterior(
        torch, pl, channels)
    max_err.update(compare_messages(torch, pl, channels))
    time_fusion(torch, pl, base, relu.region_specs)
    table = kernel_table(torch, pl, (relu, tanh), card)
    main_args = inputs(torch, 2048, torch.float32, 3)
    plain_ms = {
        "pl_posterior": post_plain_ms,
        "pl_forward_message": per_call_ms(lambda: pl.pl_forward_message_plain(
            *main_args, relu.region_specs)),
        "pl_backward_message": per_call_ms(
            lambda: pl.pl_backward_message_plain(*main_args,
                                                 relu.region_specs))}
    print(f"plain versions at relu n=2048 float32, per call: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in plain_ms.items())
        + f"; pl_posterior kernel {post_ms:.4f} ms")

    # phase 4: the relu net through the kernels, f32 and f64
    class UnfusedReluChannel(ReluChannel):
        """The relu factor as the sweep ran it before the fusion: the
        five-output kernel, torch.mean and compute_ab_new."""
        compute_forward_message = Channel.compute_forward_message
        compute_backward_message = Channel.compute_backward_message

    results = {}
    main_launches = readout_launches = None
    for dtype in (torch.float32, torch.float64):
        dname = dtype_name(dtype)
        student, x0, _ = relu_net(torch, tt, dtype)
        ep, mse, v, wall, launches = solve(torch, tt, pl, student, x0)
        check(launches["pl_forward_message"] == ep.n_iter > 0
              and launches["pl_backward_message"] == ep.n_iter
              and launches["pl_posterior"] == 0,
              f"relu net {dname}: launches {launches} for {ep.n_iter} "
              "sweeps (want one of each message per sweep and no "
              "five-output kernel)")
        readout = read_relu_posteriors(torch, pl, ep)
        check(readout == 2, f"relu posterior readout: {readout} launches of "
                            "the five-output kernel, want 2")
        if main_launches is None:
            main_launches, readout_launches = launches, readout
        results[dname] = (mse, v)
        print(f"relu net N=4096 {dname}: n_iter={ep.n_iter} mse={mse:.6g} "
              f"v={v:.6g} wall={wall:.3f} s sweeps/s="
              f"{ep.n_iter / wall:.1f} launches={launches}, posterior "
              f"readout: {readout} of pl_posterior [{card}]")
        # the sweep with the fused messages against the sweep as it ran
        # before the fusion, in turns
        unfused_ep = tt.ExpectationPropagation(relu_net(
            torch, tt, dtype, ReluChannel=UnfusedReluChannel)[0])
        unfused_ep.iterate(**SOLVE)
        check(unfused_ep.n_iter == ep.n_iter,
              f"relu net {dname}: {unfused_ep.n_iter} sweeps with the "
              f"unfused messages, {ep.n_iter} with the fused ones")
        for label, engine in (("fused", ep), ("unfused", unfused_ep),
                              ("unfused", unfused_ep), ("fused", ep)):
            kernels, device, wall_ms = sweep_window(engine)
            print(f"relu net N=4096 {dname}, {label} messages, "
                  f"torch.profiler over 10 warm sweeps: {kernels:.1f} "
                  f"kernels per sweep, device {device:.4f} ms of "
                  f"{wall_ms:.4f} ms per sweep, busy "
                  f"{100 * device / wall_ms:.2f}% [{card}]")
    (mse32, v32), (mse64, v64) = results["float32"], results["float64"]
    v_rel, mse_rel = abs(v32 - v64) / v64, abs(mse32 - mse64) / mse64
    check(v_rel < V_MSE_BOUND and mse_rel < V_MSE_BOUND,
          f"relu net f32 vs f64: v {v_rel:.3g}, mse {mse_rel:.3g} "
          f"(bound {V_MSE_BOUND})")
    print(f"relu net f32 vs f64: v rel err {v_rel:.3e}, mse rel err "
          f"{mse_rel:.3e} (bound {V_MSE_BOUND})")

    # the card's solve (kernels) against the CPU's (plain) on a small net,
    # and the card's solve against itself
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
    again = tt.ExpectationPropagation(gpu_student).iterate(**SOLVE)
    for key in ("r", "v"):
        check(torch.equal(again.get_variable_data("x")[key],
                          gpu_ep.get_variable_data("x")[key]),
              f"relu net N=256: two solves on the card differ in {key}")
    check(again.n_iter == gpu_ep.n_iter, "relu net N=256: n_iter differs "
                                         "between two solves on the card")
    print("relu net N=256 f64, two solves on the card: bit-identical x "
          "posterior")

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

    # phase 6: summary. Times at the main path's case (relu, n = 2048,
    # float32): ms and plain_ms per call by CUDA events, device_ms by
    # torch.profiler; launches from the float32 solve alone, which runs the
    # message kernels and never the five-output kernel. That kernel's
    # launches in the posterior readout after the solve stand under a key of
    # their own.
    kernels = []
    for name, source in SOURCES.items():
        row = table[name, "relu", "float32", 2048]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": "tramp_tpu/ops/pl_fused.py:81",
            "launches": main_launches[name],
            "max_abs_err": max_err[name], "ms": row["per_call_ms"],
            "plain_ms": plain_ms[name], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "device_ms": row["device_ms"], "host_ms": row["host_ms"]})
        if name == "pl_posterior":
            kernels[-1]["readout_launches"] = readout_launches
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
