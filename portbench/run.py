"""One run of one cell of the benchmark of tramp_tpu_torch.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. It needs the CUDA device(s) the cell asks for
and exits with code 3, printing no result, without them: it never falls
back to the CPU. It loads the port, makes the cell's operator on the device
from the seed, builds the model (the port takes W's SVD), solves once at the
cell's own shapes (the first run in a checkout builds the port's kernels
into build/tramp_tpu_torch/ there), and counts all of that, from the start
of this script, as ``setup_s``. Then it runs the cell's traffic, a closed
loop of one caller, for ``--seconds``; with ``--trace 1`` torch.profiler
records a few calls of that loop (the cell's ``trace_calls``). Once the
loop is over it reads the peak memory, frees the program's state, runs the
configuration's plain reference on a sample of the answers and compares.

Standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with --trace 1
its per-layer ones), ``device``, with --trace 1 ``breakdown``, and last
``checks``, each number compared beside its limit. Standard error ends with
the same numbers, one a line. The run exits with code 4, printing no
result, when jax, jaxlib, flax or tramp_tpu is loaded in this process.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import counts, manifest, trace  # noqa: E402

#: top-level modules no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tramp_tpu")
#: names of the device kernels the readers sum, by group
KERNEL_NAMES = manifest.read_json(manifest.HERE / "metrics"
                                  / "kernel_names.json")


def forbidden_modules(modules=None):
    "The loaded modules whose top-level name is one of FORBIDDEN."
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules
                  if name.split(".")[0] in FORBIDDEN)


class Run:
    """The state of one run that the traffic and the metric readers read:
    the cell's files, the seed, the device, the spans, the calls' records,
    and after the loop the window, the peak memory and the timeline."""

    def __init__(self, cell, seed, seconds, traced, device):
        import torch
        self.torch = torch
        self.config = cell.config
        self.config_module = cell.config_module
        self.reference = cell.reference
        self.traffic = cell.traffic
        self.cell = cell.cell
        self.seed = seed
        self.seconds = seconds
        self.traced = traced
        self.device = torch.device(device)
        self.spans = trace.Spans()
        self.calls = []
        self.timeline = None
        self.launches = {}
        self.kernel_names = KERNEL_NAMES

    clock = staticmethod(time.perf_counter)

    def synchronize(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    @staticmethod
    def note(line):
        "A line for standard error, printed before the result."
        print(line, file=sys.stderr, flush=True)

    def launch_counts(self):
        "The port's own counts of its message and posterior kernels."
        from tramp_tpu_torch.ops import pl_fused
        return {name: getattr(pl_fused, name).launches
                for name in ("pl_forward_message", "pl_backward_message",
                             "pl_posterior")}


def _call(run, traffic, profiled=False):
    "One call of the traffic, its record kept."
    t0 = run.clock()
    record = traffic.call(len(run.calls))
    record["wall"] = run.clock() - t0
    record["profiled"] = profiled
    run.calls.append(record)
    return record


def _traced_calls(run, traffic):
    """The cell's ``trace_calls`` calls under torch.profiler, reduced to
    ``run.timeline``, with the port's launch counts over them. A profile
    with no device event is taken again over the next calls, at most
    twice (chip_smoke.py saw such a profile twice in about a hundred)."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        before = run.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run.spans.profiling = True
            calls = [_call(run, traffic, profiled=True)
                     for _ in range(int(run.cell["trace_calls"]))]
            run.spans.profiling = False
            run.synchronize()
        timeline = trace.Timeline.from_events(trace.read_profile(prof))
        if timeline.device or attempt == 2:
            break
    after = run.launch_counts()
    run.timeline, run.traced_calls = timeline, calls
    run.launches = {k: after[k] - before[k] for k in after}


def _loop(run, traffic):
    """The measured window: calls until ``run.seconds`` have passed; in a
    traced run the calls after the first are profiled (``_traced_calls``)."""
    start = run.clock()
    _call(run, traffic)
    if run.traced:
        _traced_calls(run, traffic)
    while run.clock() - start < run.seconds:
        _call(run, traffic)
    run.synchronize()
    run.window_s = run.clock() - start


def _read_metrics(run, group, cell):
    """{name: {"value", "unit"}} of the readers that find something; a
    reader that returns None is left out of the line."""
    out = {}
    for entry, reader in cell.metrics[group]:
        value = reader.read(run)
        if value is None:
            run.note(f"metric {entry['name']}: nothing to read")
            continue
        if not math.isfinite(value):
            run.note(f"metric {entry['name']}: read {value!r}")
            continue
        out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def _number(value):
    "A float for JSON: NaN and the infinities, which JSON lacks, as None."
    return value if math.isfinite(value) else None


def _card(run):
    torch = run.torch
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(run.device),
            "count": 1}


def _power_line():
    "nvidia-smi's name and power limit of every card, for the record."
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi: {e}"
    return (f"card: {out}; peaks (H100 SXM, 700 W): "
            f"{counts.HBM_BYTES_PER_S:.3g} B/s; FMA units "
            f"{counts.PEAK_FLOPS}, products {counts.PRODUCT_PEAK_FLOPS} "
            "FLOP/s")


def main(argv=None, device=None, overrides=None):
    """Run one cell; returns the result dict (also printed), or exits.
    ``device`` and ``overrides`` ({"config" | "traffic" | "cell": {...}})
    are for the tests on the CPU: the command line has neither."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = manifest.Cell(args.workload)
    for key, values in (overrides or {}).items():
        getattr(cell, key).update(values)

    import torch
    if device is None:
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            count = (torch.cuda.device_count()
                     if torch.cuda.is_available() else 0)
            print(f"portbench: {args.workload} needs {chips} CUDA "
                  f"device(s), found {count}", file=sys.stderr)
            sys.exit(3)
        device = "cuda"
    # the configurations state float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import tramp_tpu_torch  # noqa: F401  (the port's import is set-up)

    run = Run(cell, args.seed, args.seconds, bool(args.trace), device)
    run.spans.seconds["setup.import"] = time.perf_counter() - T0
    run.spans.counts["setup.import"] = 1
    if run.device.type == "cuda":
        with run.spans("setup.context"):
            torch.cuda.init()
            torch.empty(1, device=run.device)
            run.synchronize()
    traffic = cell.kind.Traffic(run)
    traffic.setup()
    run.synchronize()
    run.setup_s = time.perf_counter() - T0
    cuda = run.device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)

    _loop(run, traffic)

    run.peak_window_bytes = (torch.cuda.max_memory_allocated(run.device)
                             if cuda else 0)
    group = "per_layer" if run.traced else "end_to_end"
    metrics = _read_metrics(run, group, cell)
    device_info = dict(_card(run), memory_peak_bytes=max(
        setup_peak, run.peak_window_bytes))
    result = {"correct": False,
              "attempted": sum(c["lanes"] for c in run.calls),
              "failed": sum(c["lanes"] - c["solved"] for c in run.calls),
              "metrics": metrics, "device": device_info}
    if run.traced and run.timeline is not None:
        device_info["busy_s"] = run.timeline.busy_s
        device_info["window_s"] = run.timeline.window_s
        result["breakdown"] = {"device_ops": run.timeline.device_ops(),
                               "idle_gaps": run.timeline.idle_gaps()}
    run.note(f"window: {len(run.calls)} calls in {run.window_s!r} s, "
             f"set-up {run.setup_s!r} s, peak memory "
             f"{run.peak_window_bytes} B in the window, {setup_peak} B in "
             "set-up")
    run.note("spans: " + json.dumps(run.spans.summary()))
    if cuda:
        run.note(_power_line())

    traffic.close()
    if cuda:
        torch.cuda.empty_cache()
    limits = cell.cell["limits"]
    t0 = time.perf_counter()
    checks = traffic.check()
    run.note(f"check: the reference took {time.perf_counter() - t0:.2f} s")
    result["correct"] = all(value <= limits[name] for name, value in checks)
    result["checks"] = {name: {"value": _number(value),
                               "limit": limits[name]}
                        for name, value in checks}

    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        sys.exit(4)
    for name, value in checks:
        print(f"check {name}: {value!r} (limit {limits[name]!r}, "
              f"{'ok' if value <= limits[name] else 'FAILS'})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return result


if __name__ == "__main__":
    main()
