"""The control of a cell's check: the plain reference put in the program's
place, computed in the precision just below the configuration's (float32
for float64; float32 with TF32 products for a float32 configuration that
states full float32 products), judged against the float64 reference by the
numbers and limits the benchmark's runs use. The check is sound only if the
control fails it.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

on a CUDA device: per seed the cell's operator and as many observations as
a run samples (the first lanes of call 0, or calls 0, 1, ... of a cell of
one lane), drawn as the run draws them. Prints, per seed, each number
beside its limit, and a last JSON line with the readings. The benchmark's
runs do not run it; portbench/tests/test_portbench_control.py does, on the
card.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import inputs, manifest  # noqa: E402
from portbench.kinds.ep import judge, reference_kw  # noqa: E402


#: the precision just below each configuration's: (dtype, TF32 products)
BELOW = {"float64": ("float32", False), "float32": ("float32", True)}


def control_readings(cell, seed, device):
    """The numbers the cell compares, for the control on ``seed``:
    [(name, value)], with the control's and the reference's n_iter."""
    import torch
    below, tf32 = BELOW[cell.config["dtype"]]
    dtype = getattr(torch, below)
    config = cell.config
    lanes = int(cell.traffic["lanes"])
    check = cell.cell["check"]
    count = int(check["calls"]) * int(check["lanes_per_call"])
    W = inputs.operator(config, seed, device)
    if lanes > 1:
        ys = inputs.observations(config, W, inputs.generator(
            device, seed, inputs.CALL, 0), lanes)[:count]
    else:
        ys = torch.cat([inputs.observations(config, W, inputs.generator(
            device, seed, inputs.CALL, i), 1) for i in range(count)])
    solver = dict(config["solver"])
    solver.update(cell.cell.get("solver", {}))
    kw = reference_kw(solver)
    got, got_n, _ = cell.reference.solve(config, W, ys, dtype=dtype,
                                         tf32=tf32, **kw)
    want, want_n, _ = cell.reference.solve(config, W, ys, **kw)
    return judge(got, want), got_n, want_n


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        sys.exit(3)
    cell = manifest.Cell(args.workload)
    limits = cell.cell["limits"]
    out = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers, got_n, want_n = control_readings(cell, seed, "cuda")
        out[seed] = dict(numbers)
        print(f"control {args.workload} seed {seed}: "
              + ", ".join(f"{name} {value!r} (limit {limits[name]!r}, "
                          f"{'passes' if value <= limits[name] else 'fails'})"
                          for name, value in numbers)
              + f"; n_iter {got_n.tolist()} against {want_n.tolist()}",
              flush=True)
    print(json.dumps({"workload": args.workload, "control": out}))


if __name__ == "__main__":
    main()
