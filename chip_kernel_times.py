"""Times of the hand-written kernels of several checkouts on one NVIDIA GPU,
in turns inside one call, so that two versions are compared on the same
card and host.

    python3 chip_kernel_times.py LABEL=DIR ...

Each argument names a checkout of this repository (DIR, "." for the current
one). The checkouts run in the order given and then in reverse (A, B, B, A),
each turn in a process of its own, because every checkout's package has the
same name. A turn builds the kernels if its checkout has not, and prints one
JSON line with ptxas's registers and spills of the instantiations with up
to three regions, then one JSON line per case: relu and hard tanh, float32
and float64, n = 2048 and n = 2**20 + 300 and, where the checkout's kernels
take lanes, 2048 lanes of 2048 elements with a precision per lane, for
``pl_posterior`` and, where the checkout has them, ``pl_forward_message``
and ``pl_backward_message``: the device time per call
from torch.profiler over 20 warm calls, the kernels launched per call, and
the host time per call (300 unsynchronised calls on the host's clock), all
taken with chip_smoke.py's own ``profiled``, ``host_ms`` and ``inputs``.
Where the checkout has ML-VAMP's loop finish (``ops/ml_vamp_finish.py``),
the kernel and its plain version are timed on the relu net's loop state
(N = 4096, M = 2048, three iterations in) at chip_smoke.py's
``FINISH_SHAPES``, with its ``finish_state``, ``finish_args`` and
``time_finish`` (the byte bound at 3.35 TB/s). The last lines give, per
checkout and case, the two turns' device times side by side, with the
card's name and power limit.

It needs one GPU and imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

# this script's own chip_smoke.py, before a turn puts its checkout first
from chip_smoke import (
    FINISH_SHAPES, LANE_SHAPE, SIZES, dtype_name, finish_args, finish_state,
    host_ms, inputs, lane_inputs, profiled, relu_net, time_finish)


def turn(label):
    "One variant's measurements; runs with the checkout as its directory."
    import torch
    sys.path.insert(0, os.getcwd())
    from tramp_tpu_torch.channels import HardTanhChannel, ReluChannel
    from tramp_tpu_torch.ops import pl_fused as pl
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    t0 = time.perf_counter()
    _, log = pl.build()
    print(json.dumps({"label": label, "build_s": time.perf_counter() - t0}),
          flush=True)
    print(json.dumps({"label": label, "ptxas": [
        row for row in pl.ptxas_report(log)
        if row["params"] and row["params"][0] <= 3]}), flush=True)
    has_lanes = os.path.exists(os.path.join("tramp_tpu_torch", "lanes.py"))
    wrappers = [name for name in ("pl_posterior", "pl_forward_message",
                                  "pl_backward_message") if hasattr(pl, name)]
    for channel in (ReluChannel(), HardTanhChannel()):
        for dtype in (torch.float32, torch.float64):
            for n in SIZES + ((LANE_SHAPE,) if has_lanes else ()):
                if n == LANE_SHAPE:
                    args = lane_inputs(torch, *n, dtype, 3)
                    n = "x".join(map(str, n))
                else:
                    args = inputs(torch, n, dtype, 3)
                for name in wrappers:
                    fn = getattr(pl, name)

                    def call():
                        return fn(*args, channel.region_specs)
                    kernels, device_ms, _ = profiled(call, 20)
                    if device_ms == 0:
                        sys.exit("torch.profiler shows no device time")
                    print(json.dumps({
                        "label": label, "kernel": name,
                        "channel": channel.name, "dtype": dtype_name(dtype),
                        "n": n, "kernels": kernels,
                        "device_us": 1e3 * device_ms,
                        "host_us": 1e3 * host_ms(call)}), flush=True)
    if os.path.exists(os.path.join("tramp_tpu_torch", "ops",
                                   "ml_vamp_finish.py")):
        finish_turn(label)


def finish_turn(label):
    "The loop finish's kernel and plain version, rows as ``turn``'s."
    import torch
    import tramp_tpu_torch as tt
    from tramp_tpu_torch.ops import _build
    from tramp_tpu_torch.ops import ml_vamp_finish as mvf
    _, log = mvf.build()
    print(json.dumps({"label": label, "finish_ptxas": [
        row for row in _build.ptxas_report(log)
        if row["kernel"] == "ml_vamp_finish_kernel"]}), flush=True)
    nets = {}
    for dname, lanes in FINISH_SHAPES:
        if dname not in nets:
            nets[dname] = relu_net(torch, tt, getattr(torch, dname))[0]
        state = finish_state(torch, nets[dname], lanes)
        for fn in (mvf.ml_vamp_finish, mvf.ml_vamp_finish_plain):
            args, nbytes = finish_args(torch, *state)
            reading = time_finish(torch, fn, args, nbytes)
            print(json.dumps({
                "label": label, "kernel": fn.__name__, "channel": "relu_net",
                "dtype": dname, "n": f"{lanes or 1}x4096",
                "kernels": reading["kernels"],
                "device_us": 1e3 * reading["device_ms"],
                "host_us": 1e3 * reading["host_ms"],
                "bound_us": 1e3 * reading["bound_ms"],
                "share": reading["share"]}), flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--turn":
        return turn(argv[1])
    variants = []
    for arg in argv:
        label, _, rest = arg.partition("=")
        variants.append((label, os.path.abspath(rest)))
    if not variants:
        sys.exit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    rows, rows_ptxas = {}, {}
    for label, directory in variants + variants[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn", label],
            cwd=directory, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{label}: exit {proc.returncode}\n{proc.stderr}")
        for line in proc.stdout.splitlines():
            print(line)
            row = json.loads(line)
            if "ptxas" in row:
                rows_ptxas.setdefault(label, row["ptxas"])
            if "kernel" in row:
                key = (row["kernel"], row["channel"], row["dtype"], row["n"])
                rows.setdefault(key, {}).setdefault(label, []).append(row)
    for label, report in rows_ptxas.items():
        print(f"{label}: registers (spill bytes) of <type, regions[, side]>: "
              + ", ".join(
                  f"{r['kernel'][3:-7]}<{r['dtype']},"
                  f"{','.join(map(str, r['params']))}> {r['registers']} "
                  f"({r['spill_bytes']})" for r in report))
    for key, by_label in rows.items():
        cells = []
        for label, turns in by_label.items():
            device = "/".join(f"{t['device_us']:.2f}" for t in turns)
            host = "/".join(f"{t['host_us']:.1f}" for t in turns)
            cells.append(f"{label}: device {device} us, host {host} us, "
                         f"{turns[0]['kernels']:.0f} launches")
        print(f"{key[0]:20s} {key[1]:7s} {key[2]} n={key[3]!s:>9s} | "
              + " | ".join(cells) + f" [{card}]")


if __name__ == "__main__":
    main(sys.argv[1:])
